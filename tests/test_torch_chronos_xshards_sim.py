"""The port's XShardsTSDataset, the forecasters' streaming input, the
DoppelGANger simulator and the deprecated AutoTS API against the JAX
package's.

XShardsTSDataset: the same frames give the same shards and the same
rolled {"x", "y"} blocks, bitwise; a forecaster fits, evaluates and
predicts from the stream and leaves the caller's roll state as it was.
The simulator: the first adversarial step from JAX's initial weights on
JAX's noise gives G's and D's updated weights and both losses within
1e-5 x max(1, |JAX|); generate, save / load.  The deprecated API: the
recipes' spaces sample as JAX's, and the dataframe-first flows run."""

import warnings
from functools import lru_cache

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import optax

from _torch_chronos_cases import (  # noqa: F401
    close,
    one_torch_thread,
    same,
)
from analytics_zoo_tpu.chronos.autots import deprecated as jax_dep
from analytics_zoo_tpu.chronos.data.experimental import (
    XShardsTSDataset as JaxXShardsTSDataset,
)
from analytics_zoo_tpu.chronos.simulator import (
    DPGANSimulator as JaxDPGANSimulator,
)
from analytics_zoo_tpu.orca.automl import hp as jax_hp
from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.chronos.autots import deprecated
from analytics_zoo_tpu_torch.chronos.data.experimental import (
    XShardsTSDataset,
)
from analytics_zoo_tpu_torch.chronos.forecaster import LSTMForecaster
from analytics_zoo_tpu_torch.chronos.simulator import DPGANSimulator
from analytics_zoo_tpu_torch.orca.automl import hp
from analytics_zoo_tpu_torch.orca.data import XShards


def _multi_id_df(n_ids=4, n_steps=60, gaps=False):
    rows = []
    for i in range(n_ids):
        ts = pd.date_range("2024-01-01", periods=n_steps, freq="h")
        vals = np.sin(0.2 * np.arange(n_steps) + i) + i
        rows.append(pd.DataFrame({"dt": ts, "value": vals, "id": str(i),
                                  "extra": np.cos(0.1 * np.arange(n_steps))
                                  * i}))
    df = pd.concat(rows, ignore_index=True)
    if gaps:
        df.loc[[3, 70, 71], "value"] = np.nan
        df = pd.concat([df, df.iloc[[10]]], ignore_index=True)
    return df


# ----------------------------------------------------------------------
# XShardsTSDataset
# ----------------------------------------------------------------------

def _xshards_flow(cls, df, **roll):
    ds = cls.from_pandas(df, dt_col="dt", target_col="value", id_col="id",
                         extra_feature_col="extra", num_shards=3)
    out = [s.copy() for s in ds.shards.collect()]
    ds = ds.deduplicate().impute().gen_dt_feature(["HOUR", "IS_WEEKEND"])
    scaled = ds.scale()
    out += [list(scaled.feature_col), scaled.shards.collect(),
            scaled.unscale_numpy(np.ones((2, 1, 1), np.float32))]
    refit = ds.scale(scaled._scalers, fit=False)
    out.append(refit.shards.collect())
    out.append(refit.roll(**roll).to_xshards().collect())
    return out


@pytest.mark.parametrize("roll", [dict(lookback=12, horizon=2),
                                  dict(lookback=8, horizon=[1, 3]),
                                  dict(lookback=55, horizon=0)],
                         ids=["h2", "h13", "h0"])
def test_xshards_tsdataset_equals_jax(roll):
    """The same shards, features, global statistics and rolled blocks
    (an id too short for a window dropped, horizon 0 without "y")."""
    df = _multi_id_df(gaps=True)
    df = df[~((df["id"] == "2") & (df.index % 60 > 40))]
    got = _xshards_flow(XShardsTSDataset, df, **roll)
    want = _xshards_flow(JaxXShardsTSDataset, df, **roll)
    same(got, want)
    with pytest.raises(ValueError, match="roll"):
        XShardsTSDataset.from_pandas(df, "dt", "value").to_xshards()
    with pytest.raises(ValueError, match="fit=False"):
        XShardsTSDataset.from_pandas(df, "dt", "value").scale(fit=False)


def test_xshards_tsdataset_from_xshards_and_global_scaling():
    df = _multi_id_df(n_ids=2, n_steps=40)
    shards = XShards([df.iloc[:50], df.iloc[50:]])
    ds = XShardsTSDataset.from_xshards(shards, dt_col="dt",
                                       target_col="value", id_col="id")
    ids = [set(s["id"]) for s in ds.shards.collect()]
    # each id wholly in one shard
    assert sum(len(i) for i in ids) == len(set().union(*ids)) == 2
    scaled = ds.scale()
    merged = pd.concat(scaled.shards.collect(), ignore_index=True)
    assert abs(merged["value"].mean()) < 1e-6
    assert abs(merged["value"].std(ddof=0) - 1.0) < 1e-3
    un = scaled.unscale_numpy(np.zeros((1, 1, 1), np.float32))
    assert np.isclose(un[0, 0, 0], df["value"].mean(), atol=1e-6)


def _streamed(n=240):
    t = pd.date_range("2020-01-01", periods=n, freq="h")
    df = pd.concat([pd.DataFrame({
        "dt": t, "id": sid,
        "value": np.sin(np.arange(n) / 12) + (1.0 if sid == "b" else 0.0)})
        for sid in ("a", "b")], ignore_index=True)
    return XShardsTSDataset.from_pandas(df, dt_col="dt",
                                        target_col="value", id_col="id",
                                        num_shards=2)


def test_forecaster_streams_xshards_tsdataset():
    """JAX's test_forecaster_streams_xshards_tsdataset and
    test_predict_does_not_poison_roll_state on the port: fit, evaluate
    and predict stream the shards; predict's horizon-0 roll keeps the
    newest window of every series and leaves the caller's roll."""
    ds = _streamed()
    ds.roll(24, 4)
    fc = LSTMForecaster(past_seq_len=24, future_seq_len=4,
                        input_feature_num=1, output_feature_num=1,
                        lr=5e-3, device="cpu")
    fc.fit(ds, epochs=4, batch_size=32)
    assert fc.evaluate(ds)["mse"] < 0.5
    preds = fc.predict(ds)
    assert preds.shape == (2 * (240 - 24 + 1), 4, 1)
    assert np.isfinite(preds).all()
    assert (ds.lookback, ds.horizon) == (24, 4)
    assert all("y" in b for b in ds.to_xshards().collect())
    # the stream predicts as the same windows in memory do
    windows = np.concatenate([b["x"] for b in ds.roll(24, 0).to_xshards()
                              .collect()])
    np.testing.assert_array_equal(fc.predict((windows, None)), preds)


# ----------------------------------------------------------------------
# DoppelGANger simulator
# ----------------------------------------------------------------------

SIM = dict(seq_len=6, feature_dim=2, attr_dim=3, noise_dim=4, hidden=8,
           lr=1e-3, seed=5)
SIM_N = 12


def _sim_data():
    rng = np.random.default_rng(0)
    return (rng.uniform(-1, 3, (SIM_N, 6, 2)).astype(np.float32),
            rng.uniform(0, 5, (SIM_N, 3)).astype(np.float32))


@lru_cache(maxsize=None)
def jax_first_step():
    """JAX's initial G and D, its noise for the first step, and its G,
    D and losses after that one step (a fit of one epoch, one batch)."""
    sim = JaxDPGANSimulator(**SIM)
    # the same init, jitted (flax's eager init of the scanned GRU takes
    # seconds, and fit calls it again), with JAX's two Adams
    init = jax.jit(lambda r, eager=sim._init_state: eager(r)[0])
    sim._init_state = lambda r: (init(r), optax.adam(sim.lr, b1=0.5),
                                 optax.adam(sim.lr, b1=0.5))
    state, _, _ = sim._init_state(jax.random.PRNGKey(SIM["seed"]))
    _, r_gen = jax.random.split(state["rng"])
    r1, r2 = jax.random.split(r_gen)
    z_a = jax.random.normal(r1, (SIM_N, SIM["noise_dim"]))
    z_s = jax.random.normal(r2, (SIM_N, SIM["seq_len"], SIM["noise_dim"]))
    feats, attrs = _sim_data()
    sim.fit(feats, attrs, epochs=1, batch_size=SIM_N)
    to_np = jax.tree_util.tree_map(np.array, (
        state["g"], state["d"], z_a, z_s, sim._state["g"], sim._state["d"]))
    return to_np + (sim.loss_history[0],)


def test_dpgan_first_step_matches_jax():
    g0, d0, z_a, z_s, g1, d1, losses = jax_first_step()
    sim = DPGANSimulator(**SIM, device="cpu")
    feats, attrs = _sim_data()
    f01, a01 = sim._scale_fit(feats, attrs)
    sim._build()
    sim.generator.load_state_dict(convert.dpgan_generator_from_flax(g0))
    sim.discriminator.load_state_dict(
        convert.dpgan_discriminator_from_flax(d0))
    # JAX's batch: its epoch's permutation of the rows
    take = np.random.default_rng(SIM["seed"]).permutation(SIM_N)
    stats = sim.gan_step(torch.from_numpy(a01[take]),
                         torch.from_numpy(f01[take]),
                         torch.from_numpy(z_a), torch.from_numpy(z_s))
    close(stats["d_loss"].item(), losses["d_loss"])
    close(stats["g_loss"].item(), losses["g_loss"])
    for got, want in (
            (convert.dpgan_generator_to_flax(sim.generator.state_dict()), g1),
            (convert.dpgan_discriminator_to_flax(
                sim.discriminator.state_dict()), d1)):
        jax.tree_util.tree_map(close, got, want)
    # the converters are each other's inverse
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           convert.dpgan_generator_to_flax(
                               convert.dpgan_generator_from_flax(g0)), g0)


def test_dpgan_fits_generates_saves_and_loads(tmp_path):
    feats, attrs = _sim_data()
    sim = DPGANSimulator(**SIM, device="cpu")
    steps = []
    step = sim.gan_step
    sim.gan_step = lambda *a: steps.append(len(a[0])) or step(*a)
    # 12 rows in batches of 11: the batch of 1 is skipped
    sim.fit(feats, attrs, epochs=3, batch_size=11)
    assert steps == [11, 11, 11]
    assert len(sim.loss_history) == 3
    assert all(np.isfinite(list(h.values())).all()
               for h in sim.loss_history)
    g_attrs, g_feats = sim.generate(16, seed=3)
    assert g_feats.shape == (16, 6, 2) and g_attrs.shape == (16, 3)
    assert g_feats.min() >= feats.min(axis=(0, 1)).min() - 1e-5
    assert (g_feats.max(axis=(0, 1)) <= feats.max(axis=(0, 1)) + 1e-5).all()
    path = sim.save(str(tmp_path / "sim.pkl"))
    again = DPGANSimulator.load(path, device="cpu").generate(16, seed=3)
    np.testing.assert_array_equal(again[1], g_feats)
    np.testing.assert_array_equal(again[0], g_attrs)
    # attr_dim 0: an attribute width of 1, zeros
    plain = DPGANSimulator(seq_len=6, feature_dim=2, noise_dim=4, hidden=8,
                           device="cpu").fit(feats, epochs=1, batch_size=6)
    assert plain.generate(2)[0].shape == (2, 1)
    with pytest.raises(ValueError, match="features must be"):
        plain.fit(feats[:, :4])
    with pytest.raises(RuntimeError, match="call fit first"):
        DPGANSimulator(seq_len=6, feature_dim=2, device="cpu").generate(1)


# ----------------------------------------------------------------------
# the deprecated AutoTS API
# ----------------------------------------------------------------------

def _df(n=200):
    t = np.arange(n)
    return pd.DataFrame({
        "datetime": pd.date_range("2020-01-01", periods=n, freq="h"),
        "value": np.sin(2 * np.pi * t / 24) + 0.05 * np.random.default_rng(
            0).normal(size=n)})


def test_recipes_sample_as_jax():
    import random
    pairs = [(deprecated.SmokeRecipe(), jax_dep.SmokeRecipe()),
             (deprecated.RandomRecipe(3), jax_dep.RandomRecipe(3)),
             (deprecated.LSTMGridRandomRecipe(hidden_dim=[8, 16]),
              jax_dep.LSTMGridRandomRecipe(hidden_dim=[8, 16]))]
    for got, want in pairs:
        assert (got.model, got.n_sampling, got.epochs) == \
            (want.model, want.n_sampling, want.epochs)
        r1, r2 = random.Random(2), random.Random(2)
        assert [hp.sample_config(got.search_space(), r1)
                for _ in range(5)] == \
            [jax_hp.sample_config(want.search_space(), r2)
             for _ in range(5)]
    with pytest.warns(UserWarning, match="num_rand_samples"):
        deprecated.LSTMGridRandomRecipe(num_rand_samples=2)


def test_autots_trainer_fits_predicts_and_loads(tmp_path):
    """JAX's test_zouwu_deprecated flows on the port."""
    df = _df()
    with pytest.warns(DeprecationWarning, match="AutoTSEstimator"):
        trainer = deprecated.AutoTSTrainer(
            horizon=2, dt_col="datetime", target_col="value",
            past_seq_len=24, device="cpu")
    pipe = trainer.fit(df.iloc[:160], validation_df=df.iloc[160:],
                       recipe=deprecated.SmokeRecipe())
    pred = pipe.predict(df.iloc[160:])
    assert pred.shape[:2] == (40 - 24 + 1, 2)
    assert pipe.predict(df.iloc[-24:]).shape[:2] == (1, 2)
    path = str(tmp_path / "zouwu")
    pipe.save(path)
    with pytest.warns(DeprecationWarning):
        again = deprecated.load_ts_pipeline(path, dt_col="datetime",
                                            target_col="value",
                                            device="cpu")
    np.testing.assert_array_equal(again.predict(df.iloc[160:]), pred)
    with pytest.warns(DeprecationWarning):
        tsp = deprecated.TimeSequencePredictor(
            future_seq_len=1, dt_col="datetime", target_col="value",
            past_seq_len=12, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        grid = tsp.fit(df.iloc[:120], recipe=deprecated.LSTMGridRandomRecipe(
            hidden_dim=[8], layer_num=[1]))
    assert grid.best_config["hidden_dim"] == 8
    assert grid.predict(df.iloc[-40:]).shape[1] == 1
