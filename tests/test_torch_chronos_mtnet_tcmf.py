"""The port's MTNet and TCMF forecasters against the JAX package's.

MTNet on JAX's weights (`convert.mtnet_forecaster_from_flax`):
predictions within 1e-5 x max(1, |JAX|), the first step's gradients
(dropout 0) within 1e-4 of each tensor's largest, the memory attention
JAX sows within 1e-6; the structure JAX's golden tests pin (the AR
highway, the memory as a set); save / load.  TCMF: the factorization's
first Adam step (F and X within 1e-5 of an optax step on the JAX
module), the windows both TCN stages are fit on (bitwise), and
`predict` global and hybrid from the same fitted state within 1e-5 x
max(1, |JAX|); fit_incremental, rolling_validation, save / load.  One
JAX program per module, cached per process."""

from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from _torch_chronos_cases import (  # noqa: F401
    GRAD_TOL,
    close,
    grads_close,
    one_torch_thread,
    series_matrix,
)
from analytics_zoo_tpu.chronos import forecaster as jax_fc
from analytics_zoo_tpu.chronos.forecaster import tcmf_forecaster as jax_tcmf
from analytics_zoo_tpu.chronos.forecaster.mtnet_forecaster import _MTNet
from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.chronos import forecaster as port_fc
from analytics_zoo_tpu_torch.chronos.forecaster import (
    tcmf_forecaster as port_tcmf,
)
from analytics_zoo_tpu_torch.chronos.forecaster.mtnet_forecaster import (
    MTNet,
)

#: the memory attention: |port - JAX| <= ATTN_TOL
ATTN_TOL = 1e-6

# ----------------------------------------------------------------------
# MTNet
# ----------------------------------------------------------------------

MTNET = dict(long_series_num=3, series_length=4, ar_window=4, cnn_hid=8,
             rnn_hid=6, horizon=2, target_num=1, dropout=0.0)


def _mtnet_windows(n=7, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 16, 2)).astype(np.float32)
    y = rng.normal(size=(n, 2, 1)).astype(np.float32)
    return x, y


@lru_cache(maxsize=None)
def jax_mtnet():
    """(params, predictions, memory attention, loss, gradients) of the
    JAX `_MTNet` on `_mtnet_windows()`, from one jitted program."""
    mod = _MTNet(**MTNET)
    x, y = _mtnet_windows()
    # jitted: flax's eager init of the scanned GRUs takes seconds
    params = jax.jit(mod.init)(jax.random.PRNGKey(0), x)["params"]

    @jax.jit
    def run(p):
        def loss(p):
            out, inter = mod.apply({"params": p}, x,
                                   mutable=["intermediates"])
            return jnp.mean((out - y) ** 2), (out, inter)
        (value, (out, inter)), grads = jax.value_and_grad(
            loss, has_aux=True)(p)
        return out, inter["intermediates"]["memory_attention"][0], value, \
            grads

    return jax.tree_util.tree_map(np.asarray, (params, *run(params)))


def _port_mtnet(**kw):
    cfg = dict(target_dim=1, feature_dim=2, long_series_num=3,
               series_length=4, ar_window_size=4, cnn_hid_size=8,
               rnn_hid_size=6, horizon=2, dropout=0.0, device="cpu")
    cfg.update(kw)
    return port_fc.MTNetForecaster(**cfg)


def test_mtnet_matches_jax():
    params, want, want_attn, want_loss, want_grads = jax_mtnet()
    fc = _port_mtnet()
    fc._estimator().set_params(convert.mtnet_forecaster_from_flax(params))
    x, y = _mtnet_windows()
    close(fc.predict((x, None), batch_size=3), want)
    model = fc._estimator().get_model()
    model.train()
    out = model(torch.from_numpy(x))
    # the memory attention JAX sows, read where the port keeps it
    attn = model.memory_attention.numpy()
    assert attn.shape == (7, 3)
    assert np.abs(attn - want_attn).max() <= ATTN_TOL
    loss = ((out - torch.from_numpy(y)) ** 2).mean()
    loss.backward()
    close(loss.item(), want_loss)
    # the time attention's bias shifts every score of a softmax alike:
    # its exact gradient is 0, and both sides give rounding noise
    grads_close(convert.mtnet_forecaster_to_flax(
        {k: p.grad for k, p in model.named_parameters()}), want_grads,
        zero=("mem_encoder/attn/bias", "short_encoder/attn/bias"))
    # the converters are each other's inverse
    jax.tree_util.tree_map(
        np.testing.assert_array_equal,
        convert.mtnet_forecaster_to_flax(model.state_dict()), params)


def _mtnet_module():
    params = jax_mtnet()[0]
    model = MTNet(2, 3, 4, 4, 8, 6, 2, 1, 0.0)
    model.load_state_dict(convert.mtnet_forecaster_from_flax(params))
    x = np.random.default_rng(0).normal(size=(5, 16, 2)).astype(np.float32)
    return model.eval(), x


def _run(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


def test_mtnet_ar_component_is_additive_and_local():
    """JAX's golden test on the port: the AR highway contributes, reads
    only the last ar_window target steps, and is linear in them."""
    model, x = _mtnet_module()
    ablated, _ = _mtnet_module()
    with torch.no_grad():
        ablated.ar.weight.zero_()
        ablated.ar.bias.zero_()

    def delta(xx):
        return _run(model, xx) - _run(ablated, xx)

    d0 = delta(x)
    assert np.abs(d0).max() > 1e-6
    x_far = x.copy()
    x_far[:, :4] += 3.0
    assert np.allclose(delta(x_far), d0, atol=1e-5)
    e = np.zeros_like(x)
    e[:, -2:] = 0.37
    assert np.allclose(delta(x + 2 * e) - d0, 2 * (delta(x + e) - d0),
                       atol=1e-4)


def test_mtnet_memory_is_a_set_and_attention_normalizes():
    """Permuting whole memory chunks leaves the prediction; reordering
    time inside the short-term chunk moves it; the memory attention is
    a simplex that the short-term chunk conditions."""
    model, x = _mtnet_module()
    base = _run(model, x)
    attn = model.memory_attention.numpy()
    assert np.all(attn >= 0)
    assert np.abs(attn.sum(axis=1) - 1.0).max() <= ATTN_TOL
    x_perm = x.copy()
    x_perm[:, 0:4], x_perm[:, 8:12] = x[:, 8:12], x[:, 0:4]
    assert np.allclose(_run(model, x_perm), base, atol=1e-5)
    x_short = x.copy()
    x_short[:, 13], x_short[:, 14] = x[:, 14], x[:, 13]
    assert not np.allclose(_run(model, x_short), base, atol=1e-6)
    x2 = x.copy()
    x2[:, 12:] = x2[:, 12:][::-1]
    _run(model, x2)
    assert not np.allclose(model.memory_attention.numpy(), attn, atol=1e-6)


def test_mtnet_memory_chunks_share_a_dropout_mask():
    """JAX vmaps the memory encoder with one dropout key for every
    chunk: identical chunks of a row encode identically in training."""
    model = MTNet(1, 3, 4, 4, 8, 6, 1, 1, 0.5).train()
    chunk = torch.randn(2, 1, 4, 1).expand(2, 3, 4, 1).reshape(6, 4, 1)
    gen = torch.Generator().manual_seed(0)
    enc = model.mem_encoder(chunk, gen, 3).reshape(2, 3, -1)
    assert torch.equal(enc[:, 0], enc[:, 1])
    assert torch.equal(enc[:, 0], enc[:, 2])
    assert not torch.equal(enc, model.mem_encoder.eval()(chunk, gen, 3)
                           .reshape(2, 3, -1))


def test_mtnet_rejects_bad_window_as_jax():
    x = np.zeros((8, 10, 1), np.float32)          # needs 12 steps
    with pytest.raises(ValueError) as want:
        _MTNet(long_series_num=2, series_length=4, ar_window=4, cnn_hid=8,
               rnn_hid=8, horizon=1, target_num=1, dropout=0.0).init(
            jax.random.PRNGKey(0), x)
    fc = port_fc.MTNetForecaster(long_series_num=2, series_length=4,
                                 horizon=1, device="cpu")
    with pytest.raises(ValueError) as got:
        fc.fit({"x": x, "y": np.zeros((8, 1, 1), np.float32)}, epochs=1)
    assert str(got.value) == str(want.value)
    assert port_fc.MTNetForecaster(long_series_num=1, series_length=2,
                                   ar_window_size=9,
                                   device="cpu").ar_window_size == 4


def test_mtnet_fits_saves_and_loads(tmp_path):
    x, y = _mtnet_windows(n=64, seed=1)
    fc = _port_mtnet(lr=1e-2, dropout=0.1)
    fc.fit({"x": x, "y": y}, epochs=3, batch_size=32)
    losses = [s["loss"] for s in fc._estimator().train_summary]
    assert losses[-1] < losses[0]
    assert set(fc.evaluate({"x": x, "y": y})) == {"loss", "mse", "mae"}
    path = fc.save(str(tmp_path / "mtnet.pkl"))
    loaded = port_fc.MTNetForecaster.load(path, device="cpu")
    np.testing.assert_array_equal(loaded.predict({"x": x}),
                                  fc.predict({"x": x}))
    assert loaded._config() == fc._config()


# ----------------------------------------------------------------------
# TCMF
# ----------------------------------------------------------------------

N, T, RANK, LB = 6, 40, 3, 8


@lru_cache(maxsize=None)
def jax_factorization_step():
    """(initial params, params after one optax Adam step on the MSE) of
    JAX's `_Factorization` on the tiled ids, as its Estimator trains
    it (one batch holds every row)."""
    y = series_matrix(N, T)
    yn = (y - y.mean(axis=1, keepdims=True)) / (
        y.std(axis=1, keepdims=True) + 1e-6)
    reps = max(1, min(16, 512 // N))
    ids, target = np.tile(np.arange(N, dtype=np.int32), reps), \
        np.tile(yn, (reps, 1))
    mod = jax_tcmf._Factorization(N, RANK, T)
    params = jax.jit(mod.init)(jax.random.PRNGKey(0), ids)["params"]
    tx = optax.adam(5e-3)

    @jax.jit
    def step(p):
        g = jax.grad(lambda p: jnp.mean(
            (mod.apply({"params": p}, ids) - target) ** 2))(p)
        upd, _ = tx.update(g, tx.init(p), p)
        return optax.apply_updates(p, upd)

    return (jax.tree_util.tree_map(np.asarray, params),
            jax.tree_util.tree_map(np.asarray, step(params)), y)


def test_tcmf_factorization_step_matches_jax():
    params, want, y = jax_factorization_step()
    fc = port_tcmf.TCMFForecaster(rank=RANK, device="cpu")
    fc._prepare({"y": y})
    est = fc._factorization_estimator()
    # no shard_rules: one card has no mesh (JAX shards the table)
    est.set_params(convert.tcmf_factorization_from_flax(params))
    data = fc._factorization_data()
    assert len(data["x"]) == N * 16 and data["x"].dtype == np.int32
    est.fit(data, epochs=1, batch_size=len(data["x"]), shuffle=False)
    got = convert.tcmf_factorization_to_flax(est.get_model().state_dict())
    for k in ("x_basis",):
        close(got[k], want[k])
    close(got["embed_f"]["embedding"], want["embed_f"]["embedding"])


def _fitted_state(cls, hybrid=True, use_time=True, **kw):
    """A TCMF of `cls` with a fitted state made by hand (no fit): F, X,
    the normalized series and the covariates, the same in both
    packages."""
    rng = np.random.default_rng(3)
    fc = cls(rank=RANK, tcn_lookback=LB, num_channels_X=(4, 4),
             num_channels_Y=(3,), hybrid=hybrid, use_time=use_time, **kw)
    y = series_matrix(N, T, seed=3)
    fc.n, fc.T = y.shape
    fc._y_mean = y.mean(axis=1, keepdims=True)
    fc._y_std = y.std(axis=1, keepdims=True) + 1e-6
    fc._yn = (y - fc._y_mean) / fc._y_std
    fc._ramp_scale = T
    fc._cov = fc._stack_covariates(
        T, rng.normal(size=(1, T)).astype(np.float32), None)
    fc._F = rng.normal(size=(N, RANK)).astype(np.float32)
    fc._X = rng.normal(size=(RANK, T)).astype(np.float32)
    return fc


def _captured_fits(monkeypatch, module, stage, cls, **kw):
    """The {"x", "y"}, epochs and batch size a TCMF stage hands to
    `TCNForecaster.fit` (the fit itself skipped)."""
    seen = []
    monkeypatch.setattr(module.TCNForecaster, "fit",
                        lambda self, data, epochs, batch_size:
                        seen.append((data, epochs, batch_size)))
    fc = _fitted_state(cls, **kw)
    getattr(fc, stage)(7)
    return seen[0]


@pytest.mark.parametrize("stage,samples", [
    ("_fit_basis_tcn", None), ("_fit_local", None), ("_fit_local", 50)])
def test_tcmf_stage_windows_equal_jax(monkeypatch, stage, samples):
    """Both TCN stages are fit on JAX's windows, bitwise, with JAX's
    epochs and batch size; the local stage's subsample is drawn as
    JAX draws it."""
    kw = {} if samples is None else {"max_local_samples": samples}
    want = _captured_fits(monkeypatch, jax_fc, stage,
                          jax_tcmf.TCMFForecaster, **kw)
    got = _captured_fits(monkeypatch, port_fc, stage,
                         port_tcmf.TCMFForecaster, device="cpu", **kw)
    assert got[1:] == want[1:]
    for k in ("x", "y"):
        assert got[0][k].dtype == want[0][k].dtype
        np.testing.assert_array_equal(got[0][k], want[0][k])


def _tcn_params(n_in, channels, seed):
    module = jax_fc.TCNForecaster(past_seq_len=LB, input_feature_num=n_in,
                                  num_channels=channels)._build_module()
    x = np.zeros((1, LB, n_in), np.float32)
    return jax.tree_util.tree_map(np.asarray, jax.jit(module.init)(
        jax.random.PRNGKey(seed), x)["params"])


@pytest.mark.parametrize("hybrid", [False, True])
def test_tcmf_predict_equals_jax_from_the_same_state(hybrid):
    """From the same fitted state and TCN weights, the rolled basis,
    the global recombination and the hybrid local roll agree."""
    fc_j = _fitted_state(jax_tcmf.TCMFForecaster, hybrid=hybrid)
    fc_p = _fitted_state(port_tcmf.TCMFForecaster, hybrid=hybrid,
                         device="cpu")
    basis = _tcn_params(1, (4, 4), 1)
    fc_j._tcn = jax_fc.TCNForecaster(past_seq_len=LB,
                                     num_channels=(4, 4))
    fc_j._tcn._estimator()._params = basis
    fc_p._tcn = fc_p._tcn_forecaster(1, (4, 4))
    fc_p._tcn._estimator().set_params(
        convert.tcn_forecaster_from_flax(basis))
    if hybrid:
        local = _tcn_params(fc_p._local_channels(), (3,), 2)
        fc_j._local = jax_fc.TCNForecaster(
            past_seq_len=LB, input_feature_num=fc_j._local_channels(),
            num_channels=(3,))
        fc_j._local._estimator()._params = local
        fc_p._local = fc_p._tcn_forecaster(fc_p._local_channels(), (3,))
        fc_p._local._estimator().set_params(
            convert.tcn_forecaster_from_flax(local))
    cov = np.random.default_rng(4).normal(size=(1, 3)).astype(np.float32)
    want = fc_j.predict(horizon=3, future_covariates=cov)
    got = fc_p.predict(horizon=3, future_covariates=cov)
    close(got, want)
    if hybrid:
        with pytest.raises(ValueError) as w:
            fc_j.predict(horizon=3)
        with pytest.raises(ValueError) as g:
            fc_p.predict(horizon=3)
        assert str(g.value) == str(w.value)


def test_tcmf_time_covariates_equal_jax():
    import pandas as pd
    dti = pd.date_range("2021-03-01", periods=30, freq="7h")
    for args in ((30, dti), (30, None, 5, 20), (4, None, 0, None)):
        np.testing.assert_array_equal(port_tcmf._time_covariates(*args),
                                      jax_tcmf._time_covariates(*args))


def test_tcmf_fits_rolls_forward_saves_and_loads(tmp_path):
    y = series_matrix(8, 48, seed=5)
    fc = port_tcmf.TCMFForecaster(rank=3, tcn_lookback=8,
                                  num_channels_X=(4,), num_channels_Y=(4,),
                                  lr=1e-2, device="cpu")
    fc.fit({"y": y[:, :40]}, epochs=4)
    assert fc._X.shape == (3, 40) and fc._F.shape == (8, 3)
    pred = fc.predict(horizon=4)
    assert pred.shape == (8, 4) and np.isfinite(pred).all()
    path = fc.save(str(tmp_path / "tcmf.pkl"))
    loaded = port_tcmf.TCMFForecaster.load(path, device="cpu")
    np.testing.assert_array_equal(loaded.predict(horizon=4), pred)
    # a loaded model rolls forward too
    loaded.fit_incremental({"y": y[:, 40:44]}, epochs=2)
    assert loaded.T == 44 and loaded._X.shape == (3, 44)
    assert loaded.predict(horizon=2).shape == (8, 2)
    with pytest.raises(ValueError, match="same 8 series"):
        loaded.fit_incremental({"y": y[:3, 40:44]})
    with pytest.raises(RuntimeError, match="fit before fit_incremental"):
        port_tcmf.TCMFForecaster(device="cpu").fit_incremental(y)
    stats = fc.evaluate({"y": y[:, 40:44]}, metric=("mse", "mae"))
    assert set(stats) == {"mse", "mae"}


def test_tcmf_rolling_validation():
    y = series_matrix(5, 40, seed=6)
    fc = port_tcmf.TCMFForecaster(rank=2, tcn_lookback=6,
                                  num_channels_X=(4,), num_channels_Y=(4,),
                                  lr=1e-2, device="cpu")
    out = fc.rolling_validation({"y": y}, tau=4, n=2, epochs=4,
                                epochs_incr=2, metric=("mse", "mae"))
    assert set(out) == {"mse", "mae", "rounds"} and len(out["rounds"]) == 2
    assert fc.T == 40
    with pytest.raises(ValueError) as w:
        jax_tcmf.TCMFForecaster(tcn_lookback=8).rolling_validation(
            {"y": y[:, :20]}, tau=8, n=2)
    with pytest.raises(ValueError) as g:
        port_tcmf.TCMFForecaster(tcn_lookback=8,
                                 device="cpu").rolling_validation(
            {"y": y[:, :20]}, tau=8, n=2)
    assert str(g.value) == str(w.value)
