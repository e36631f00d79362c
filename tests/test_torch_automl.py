"""The port's AutoML against the JAX package's: the `hp` samplers, the
`SearchEngine`'s trial tables (configs, metrics, epochs, stopped,
errors) for random, grid and TPE sampling on pure-Python trainables,
the `Evaluator`'s metrics, the device lease, the device and process
backends, and `AutoEstimator.from_torch`, whose process backend
rebuilds the best model from its worker's export.  The trainables of
the process backend live in `_torch_automl_cases.py`, which the
spawned workers import."""

import math
import random
import threading
import time

import numpy as np
import pytest
import torch

import _torch_automl_cases as cases
from analytics_zoo_tpu.orca.automl import hp as jax_hp
from analytics_zoo_tpu.orca.automl.auto_estimator import (
    AutoEstimator as JaxAutoEstimator,
)
from analytics_zoo_tpu.orca.automl.metrics import Evaluator as JaxEvaluator
from analytics_zoo_tpu.orca.automl.search_engine import (
    SearchEngine as JaxSearchEngine,
)
from analytics_zoo_tpu_torch.common import device_lease as lease
from analytics_zoo_tpu_torch.observability import get_registry
from analytics_zoo_tpu_torch.orca.automl import AutoEstimator, hp
from analytics_zoo_tpu_torch.orca.automl.metrics import Evaluator
from analytics_zoo_tpu_torch.orca.automl.search_engine import SearchEngine


def _space(mod, kind):
    """The same search space in the `hp` module `mod`."""
    return {
        "choice": {"p": mod.choice([1.0, 2.0, 4.0, 8.0])},
        "grid": {"p": mod.grid_search([8.0, 4.0, 6.0, 2.0])},
        "grid_nan": {"p": mod.grid_search([0, 3.0, 2.0])},
        "grid_1234": {"p": mod.grid_search([1.0, 2.0, 3.0, 4.0])},
        "pair": {"p": mod.choice([1.0, 2.0])},
        "uniform": {"p": mod.uniform(0.0, 1.0)},
        "cat_log": {"act": mod.choice(["relu", "tanh", "sigmoid"]),
                    "lr": mod.loguniform(1e-4, 1e-1)},
        "int_q": {"n_layers": mod.randint(1, 6),
                  "q": mod.quniform(0.0, 1.0, 0.25)},
        "grid_extra": {"lr": mod.grid_search([1.0, 2.0]),
                       "units": mod.uniform(16, 64), "fixed": 7},
    }[kind]


def _halving(config, state, epochs):
    state = (state or 0) + epochs
    return state, config["p"] / state


def _nan_p0(config, state, epochs):
    return (state or 0) + epochs, (float("nan") if config["p"] == 0
                                   else config["p"])


def _quadratic(config, state, epochs):
    return None, (config["p"] - 0.7) ** 2


def _cat_log(config, state, epochs):
    penalty = 0.0 if config["act"] == "relu" else 1.0
    return None, penalty + abs(math.log10(config["lr"]) + 2)


def _int_q(config, state, epochs):
    return None, abs(config["n_layers"] - 3) + abs(config["q"] - 0.5)


def _first_lr(config, state, epochs):
    return None, config["lr"]


def _winner_dies(config, state, epochs):
    if config["p"] == 1.0:
        raise RuntimeError("boom")
    return None, config["p"]


#: (space, trainable, SearchEngine keywords): the JAX tests' searches
SEARCHES = {
    "halving": ("choice", _halving, dict(n_sampling=8, epochs=4,
                                         grace_epochs=1)),
    "halving_eta3": ("choice", _halving, dict(n_sampling=9, epochs=9,
                                              grace_epochs=1, eta=3,
                                              seed=5)),
    "grid_rungs": ("grid", cases.counting_trainable,
                   dict(epochs=4, grace_epochs=1)),
    "nan_never_wins": ("grid_nan", _nan_p0, dict(epochs=1)),
    "lone_survivor": ("pair", _halving, dict(n_sampling=2, epochs=4,
                                             grace_epochs=1)),
    "tpe_quadratic": ("uniform", _quadratic, dict(
        n_sampling=16, epochs=1, seed=3, search_algorithm="tpe")),
    "tpe_categorical_log": ("cat_log", _cat_log, dict(
        n_sampling=20, epochs=1, seed=0, search_algorithm="tpe")),
    "tpe_int_quantized": ("int_q", _int_q, dict(
        n_sampling=12, epochs=1, seed=1, search_algorithm="tpe")),
    "tpe_grid_stays_grid": ("grid_extra", _first_lr, dict(
        n_sampling=6, epochs=1, search_algorithm="tpe")),
    "error_culled_threads": ("grid_1234", _winner_dies, dict(
        epochs=1, parallelism=2)),
    "device_backend": ("grid", cases.counting_trainable, dict(
        epochs=4, grace_epochs=1, backend="device")),
}


def _table(engine):
    """The trial table with NaN metrics made comparable."""
    rows = engine.trial_table()
    for r in rows:
        if r["metric"] is not None and math.isnan(r["metric"]):
            r["metric"] = "nan"
    return rows


@pytest.mark.parametrize("kind", ["choice", "uniform", "cat_log", "int_q",
                                  "grid_extra"])
def test_hp_samples_equal_jax(kind):
    port_rng, jax_rng = random.Random(11), random.Random(11)
    port, ref = _space(hp, kind), _space(jax_hp, kind)
    got = [hp.sample_config(port, port_rng) for _ in range(50)]
    want = [jax_hp.sample_config(ref, jax_rng) for _ in range(50)]
    assert got == want
    for k, v in port.items():
        if isinstance(v, (hp.Choice, hp.GridSearch)):
            assert v.grid_values() == ref[k].grid_values()
        elif isinstance(v, hp.SampleSpace):
            with pytest.raises(NotImplementedError):
                v.grid_values()


@pytest.mark.parametrize("name", sorted(SEARCHES))
def test_trial_table_equals_jax(name):
    kind, trainable, kw = SEARCHES[name]
    want_engine = JaxSearchEngine(trainable, _space(jax_hp, kind), **kw)
    want = want_engine.run()
    engine = SearchEngine(trainable, _space(hp, kind), **kw)
    best = engine.run()
    assert _table(engine) == _table(want_engine)
    assert best.trial_id == want.trial_id
    assert best.epochs_trained == want.epochs_trained


def test_searches_reach_the_jax_tests_results():
    """The JAX tests' own assertions, on the port's engine."""
    def run(name):
        kind, trainable, kw = SEARCHES[name]
        engine = SearchEngine(trainable, _space(hp, kind), **kw)
        return engine, engine.run()

    engine, best = run("halving")
    assert best.best_metric == min(t.best_metric for t in engine.trials
                                   if t.best_metric is not None)
    assert any(t.stopped for t in engine.trials)
    assert run("nan_never_wins")[1].config["p"] == 2.0
    assert run("lone_survivor")[1].epochs_trained == 4
    engine, best = run("tpe_quadratic")
    assert abs(best.config["p"] - 0.7) < 0.2
    warm = np.array([t.config["p"] for t in engine.trials[:8]])
    guided = np.array([t.config["p"] for t in engine.trials[8:]])
    assert len(guided) == 8
    assert np.abs(guided - 0.7).mean() < np.abs(warm - 0.7).mean()
    best = run("tpe_categorical_log")[1]
    assert best.config["act"] == "relu" and 1e-3 < best.config["lr"] < 1e-1
    assert isinstance(run("tpe_int_quantized")[1].config["n_layers"], int)
    assert len(run("tpe_grid_stays_grid")[0].trials) == 2
    engine, best = run("error_culled_threads")
    assert best.config["p"] == 2.0
    dead = [r for r in engine.trial_table() if r["config"]["p"] == 1.0]
    assert dead[0]["stopped"] and dead[0]["error"] == "RuntimeError: boom"


def _nope(config, state, epochs):
    raise ValueError("nope")


def test_all_trials_error_raises_as_jax():
    messages = []
    for mod, cls in ((jax_hp, JaxSearchEngine), (hp, SearchEngine)):
        engine = cls(_nope, {"p": mod.choice([1.0])}, n_sampling=2,
                     epochs=1)
        with pytest.raises(RuntimeError, match="all trials") as err:
            engine.run()
        messages.append(str(err.value))
        assert [r["error"] for r in engine.trial_table()] == \
            ["ValueError: nope"] * 2
    assert messages[0] == messages[1]


@pytest.mark.parametrize("kw", [dict(metric_mode="mean"),
                                dict(backend="ray"),
                                dict(search_algorithm="bayes")],
                         ids=["mode", "backend", "algorithm"])
def test_bad_arguments_raise_as_jax(kw):
    with pytest.raises(ValueError) as want:
        JaxSearchEngine(_nope, {}, **kw)
    with pytest.raises(ValueError) as got:
        SearchEngine(_nope, {}, **kw)
    assert str(got.value) == str(want.value)


METRICS = ["me", "mae", "mse", "rmse", "msle", "r2", "mape", "mpe", "smape",
           "mdape", "smdape", "mspe", "accuracy", "precision", "recall",
           "f1", "auc"]


@pytest.mark.parametrize("metric", METRICS)
def test_evaluator_equals_jax(metric):
    rng = np.random.default_rng(7)
    if metric in ("accuracy", "precision", "recall", "f1", "auc"):
        cases_ = [(rng.integers(0, 2, 40), rng.random(40), {}),
                  (rng.integers(0, 2, 40), rng.normal(size=40),
                   {"from_logits": True}),
                  (np.eye(2)[rng.integers(0, 2, 40)], rng.random((40, 2)),
                   {})]
    else:
        cases_ = [(rng.normal(size=(30, 3)), rng.normal(size=(30, 3)), {}),
                  (rng.random(30) + 0.5, rng.random(30) + 0.5, {})]
    for y_true, y_pred, kw in cases_:
        for multioutput in ("raw_values", "uniform_average"):
            got = Evaluator.evaluate(metric, y_true, y_pred,
                                     multioutput=multioutput, **kw)
            want = JaxEvaluator.evaluate(metric, y_true, y_pred,
                                         multioutput=multioutput, **kw)
            np.testing.assert_array_equal(got, want)
    assert Evaluator.get_metric_mode(metric) == \
        JaxEvaluator.get_metric_mode(metric)


def test_evaluator_refusals_as_jax():
    for fn, args in ((lambda e: e.check_metric("bogus"), ()),
                     (lambda e: e.evaluate("mse", np.zeros(3), np.zeros(4)),
                      ()),
                     (lambda e: e.evaluate("mse", np.zeros(3), np.zeros(3),
                                           multioutput="sum"), ()),
                     (lambda e: e.evaluate("auc", np.zeros(3),
                                           np.zeros((3, 3))), ())):
        with pytest.raises(ValueError) as want:
            fn(JaxEvaluator)
        with pytest.raises(ValueError) as got:
            fn(Evaluator)
        assert str(got.value) == str(want.value)


def test_lease_is_exclusive_and_reports_holder():
    entered, release = threading.Event(), threading.Event()
    waits = get_registry().histogram("device_lease_wait_seconds")
    holds = get_registry().histogram("device_lease_hold_seconds")
    n0 = (waits.calls, holds.calls)

    def hold():
        with lease.device_lease("holder-A"):
            entered.set()
            release.wait(timeout=10)

    t = threading.Thread(target=hold, daemon=True)
    t.start()
    assert entered.wait(timeout=5)
    assert lease.current_holder() == "holder-A"
    with pytest.raises(TimeoutError, match="holder-A"):
        with lease.device_lease("holder-B", timeout=0.05):
            pass
    release.set()
    t.join(timeout=5)
    assert not t.is_alive()
    with lease.device_lease("holder-C", timeout=5):
        assert lease.current_holder() == "holder-C"
    assert lease.current_holder() is None
    assert lease.history(2) == ["holder-A", "holder-C"]
    assert (waits.calls, holds.calls) == (n0[0] + 2, n0[1] + 2)


def _sleepy(config, state, add_epochs):
    t0 = time.perf_counter()
    time.sleep(0.03)
    _WINDOWS.append((t0, time.perf_counter()))
    return (state or 0) + add_epochs, config["p"]


_WINDOWS = []


def test_device_backend_serializes_trials_under_contention():
    """Two device-backend searches on two threads: across both, no two
    trials hold the card at once."""
    _WINDOWS.clear()
    space = {"p": hp.grid_search([4.0, 2.0, 3.0, 1.0])}
    n0 = lease.stats()["acquisitions"]
    bests = [None, None]

    def run(k):
        bests[k] = SearchEngine(_sleepy, space, epochs=1,
                                backend="device").run()

    threads = [threading.Thread(target=run, args=(k,), daemon=True)
               for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert bests[0].config["p"] == bests[1].config["p"] == 1.0
    assert lease.stats()["acquisitions"] - n0 == 8
    assert all(h.startswith("automl-trial-") for h in lease.history(8))
    windows = sorted(_WINDOWS)
    for (_, end), (start, _) in zip(windows, windows[1:]):
        assert start >= end, "device trial windows overlapped"


def test_device_backend_real_estimator_trials():
    """JAX's `test_device_backend_real_estimator_trials` with
    `Estimator.from_torch` trials (on the CPU here): one lease
    acquisition a trial call, each trial its own model, and the winner
    trained."""
    calls = []

    def trainable(config, state, add_epochs):
        calls.append(config["width"])
        state = state or cases.mlp_creator(config)
        state.fit({"x": cases.X, "y": cases.Y}, epochs=add_epochs,
                  batch_size=32)
        return state, state.evaluate({"x": cases.X, "y": cases.Y},
                                     batch_size=64)["loss"]

    n0 = lease.stats()["acquisitions"]
    engine = SearchEngine(trainable, {"width": hp.grid_search([4, 8, 16,
                                                               32]),
                                      "lr": hp.choice([1e-2])},
                          epochs=4, grace_epochs=1, backend="device")
    best = engine.run()
    assert lease.stats()["acquisitions"] - n0 == len(calls) == 7
    assert lease.current_holder() is None
    assert best.best_metric < 0.7 * float(np.var(cases.Y))
    assert {r["config"]["width"] for r in engine.trial_table()} == \
        {4, 8, 16, 32}
    assert best.state.get_model().fc1.out_features == best.config["width"]


def test_process_backend_workers_see_no_card_and_match_serial(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "7")
    space = {"p": hp.grid_search([4.0, 2.0, 1.0, 3.0])}
    engine = SearchEngine(cases.proc_trainable, space, epochs=4,
                          grace_epochs=1, parallelism=2, backend="process")
    best = engine.run()
    # restored after the spawn; the workers saw "" (or every trial
    # would have raised)
    import os
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "7"
    assert best.config["p"] == 1.0 and best.epochs_trained == 4
    assert best.state == ("raw", 4)
    assert all(r["error"] is None for r in engine.trial_table())
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    ref = JaxSearchEngine(cases.proc_trainable,
                          {"p": jax_hp.grid_search([4.0, 2.0, 1.0, 3.0])},
                          epochs=4, grace_epochs=1)
    ref.run()
    assert _table(engine) == _table(ref)


def test_auto_estimator_process_backend_exports_the_best_model():
    """`AutoEstimator.from_torch` over spawned workers: the best trial's
    parameters and buffers come back as numpy and the parent rebuilds
    its Estimator with them; the same search in this process (the
    thread backend) trains the same weights."""
    space = {"width": hp.grid_search([4, 8]), "lr": hp.choice([1e-2]),
             "seed": 3}
    data = {"x": cases.X, "y": cases.Y}
    auto = AutoEstimator.from_torch(cases.mlp_creator, metric="loss")
    auto.fit(data, search_space=space, epochs=2, batch_size=32,
             parallelism=2, backend="process")
    here = AutoEstimator.from_torch(cases.mlp_creator, metric="loss")
    here.fit(data, search_space=space, epochs=2, batch_size=32)
    assert auto.get_best_config() == here.get_best_config()
    got, want = auto.get_best_model(), here.get_best_model()
    assert got is not want and got.engine is not None
    sd, ref = got.get_model().state_dict(), want.get_model().state_dict()
    assert set(sd) == set(ref) and float(sd["seen"]) == 128 * 2
    for k in sd:
        torch.testing.assert_close(sd[k], ref[k], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.predict({"x": cases.X}),
                               want.predict({"x": cases.X}),
                               rtol=1e-5, atol=1e-5)
    for row, ref_row in zip(auto.get_trial_table(), here.get_trial_table()):
        assert row["config"] == ref_row["config"]
        assert row["metric"] == pytest.approx(ref_row["metric"], rel=1e-5)


def test_auto_estimator_tables_equal_jax():
    """A picklable estimator through both packages' AutoEstimator: the
    same trial table, and the port's rebuild hands the export to
    `set_params`."""
    data = {"x": np.zeros(4), "y": np.zeros(4)}
    want = JaxAutoEstimator.from_flax(cases.tiny_creator, metric="loss")
    want.fit(data, search_space={"lr": jax_hp.grid_search([0.9, 0.5, 0.7])},
             epochs=3)
    got = AutoEstimator.from_torch(cases.tiny_creator, metric="loss")
    got.fit(data, search_space={"lr": hp.grid_search([0.9, 0.5, 0.7])},
            epochs=3, parallelism=2, backend="process")
    assert got.get_trial_table() == want.get_trial_table()
    assert got.get_best_config() == want.get_best_config() == {"lr": 0.5}
    best = got.get_best_model()
    assert isinstance(best, cases.TinyEst) and best.loss == 10.0
    assert set(best.params) == {"w", "count"}
    assert float(best.params["w"]) == pytest.approx(10.0 * 0.5 ** 3)
    assert best.params["count"].tolist() == [3]
    assert AutoEstimator.from_keras is AutoEstimator.from_torch
    assert not hasattr(AutoEstimator, "from_flax")
    with pytest.raises(RuntimeError, match="call fit first"):
        AutoEstimator(cases.tiny_creator).get_best_model()


def test_auto_estimator_search_alg_passthrough():
    """JAX's test on the port: a TPE search of real Estimators."""
    from analytics_zoo_tpu_torch.orca.learn import Estimator

    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    y = (x.sum(1) > 0).astype(np.int32)

    def creator(config):
        model = torch.nn.Sequential(
            torch.nn.Linear(4, int(config["hidden"])), torch.nn.ReLU(),
            torch.nn.Linear(int(config["hidden"]), 2))
        return Estimator.from_torch(
            model, loss="sparse_categorical_crossentropy", optimizer="sgd",
            learning_rate=config["lr"])

    auto = AutoEstimator.from_torch(creator)
    auto.fit({"x": x, "y": y},
             search_space={"lr": hp.loguniform(1e-3, 1e-1),
                           "hidden": hp.choice([8, 16])},
             n_sampling=4, epochs=1, batch_size=32, search_alg="tpe")
    assert auto.get_best_config()["hidden"] in (8, 16)
    assert len(auto.get_trial_table()) == 4
