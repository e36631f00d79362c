"""The port's DEVICE data store (`OrcaContext.train_data_store =
"DEVICE"`: the dataset uploaded once and each epoch indexing it in
place), after tests/test_device_cache.py, on the CPU (the store's
device is the module's): it trains step for step as the host path does
without shuffle, shuffles on the device visiting each real row once an
epoch, caches its upload across fits on the same arrays, re-uploads a
mutated source, keeps the total under `device_cache_bytes`, streams
from the host over the cap, and skips a non-finite step.

Tolerance: none where both paths run the same batches through the same
f32 arithmetic (losses and parameters compared exactly), since the
DEVICE store only changes where each batch is read from."""

import logging

import numpy as np
import pytest
import torch
from torch import nn

from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.orca.learn import Estimator
from analytics_zoo_tpu_torch.orca.learn.spmd import TrainEngine


@pytest.fixture(autouse=True)
def _ctx():
    prev = OrcaContext.train_data_store, OrcaContext.device_cache_bytes
    yield
    OrcaContext.train_data_store, OrcaContext.device_cache_bytes = prev


def _toy(n=203, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(np.int32)
    return x, y


def _estimator(seed=0):
    torch.manual_seed(seed)
    mlp = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 2))
    return Estimator.from_torch(mlp, loss="sparse_categorical_crossentropy",
                                optimizer="sgd", learning_rate=0.1,
                                metrics=["accuracy"])


def _fit(store, shuffle, epochs=2, batch=33, data=None):
    OrcaContext.train_data_store = store
    x, y = data if data is not None else _toy()
    est = _estimator()
    steps = []
    for _ in range(epochs):
        est.fit({"x": x, "y": y}, epochs=1, batch_size=batch,
                shuffle=shuffle)
        steps += est.engine.last_steps
    return est, steps


def test_context_validates_the_store():
    with pytest.raises(ValueError, match="DRAM"):
        OrcaContext.train_data_store = "HBM_EXTREME"
    OrcaContext.train_data_store = "device"
    assert OrcaContext.train_data_store == "DEVICE"
    OrcaContext.train_data_store = "disk_2"
    assert OrcaContext.train_data_store == "DISK_2"
    assert OrcaContext.device_cache_bytes > 0


@pytest.mark.parametrize("batch", [33, 29, 203, 256])
def test_device_matches_dram_step_for_step(batch):
    host, host_steps = _fit("DRAM", shuffle=False, batch=batch)
    dev, dev_steps = _fit("DEVICE", shuffle=False, batch=batch)
    # 203 rows: ceil(203 / batch) steps an epoch, the last ragged
    assert len(dev_steps) == len(host_steps) == 2 * -(-203 // batch)
    assert dev.engine.host_step == host.engine.host_step
    assert dev_steps == host_steps
    assert [s["_count"] for s in dev_steps[:-(-203 // batch)]] == \
        [min(batch, 203 - k * batch) for k in range(-(-203 // batch))]
    for a, b in zip(dev.get_model().parameters(),
                    host.get_model().parameters()):
        assert torch.equal(a, b)
    x, _ = _toy()
    np.testing.assert_array_equal(dev.predict({"x": x}),
                                  host.predict({"x": x}))


def test_disk_store_streams_from_the_host():
    _, host_steps = _fit("DRAM", shuffle=True)
    disk, disk_steps = _fit("DISK_2", shuffle=True)
    assert disk_steps == host_steps and not disk._device_cache


def test_layout_pads_only_the_last_step():
    eng = _estimator().engine
    x, y = _toy()
    dds = eng.cache_dataset((x,), (y,), 33)
    assert TrainEngine.cached_layout(203, 33) == (7, 33)
    assert (dds.steps, dds.batch, dds.n_real) == (7, 33, 203)
    assert dds.data["features"][0].shape == (7, 33, 8)
    mask = dds.data["mask"]
    assert mask.sum(dim=1).tolist() == [33.0] * 6 + [5.0]
    np.testing.assert_array_equal(
        dds.data["features"][0].reshape(-1, 8)[:203].numpy(), x)
    assert float(dds.data["features"][0][6, 5:].abs().sum()) == 0.0
    assert dds.nbytes == 7 * 33 * (8 * 4 + 4 + 4)


def test_shuffle_visits_every_real_row_once_an_epoch_and_learns():
    OrcaContext.train_data_store = "DEVICE"
    x, y = _toy()
    est = _estimator()
    eng = est.engine
    seen = []

    def spy(batch, step=eng.train_step):
        real = batch["mask"] > 0
        seen.append(batch["features"][0][real].clone())
        return step(batch)

    eng.train_step = spy
    orders = []
    for _ in range(10):
        seen.clear()
        est.fit({"x": x, "y": y}, epochs=1, batch_size=33, shuffle=True)
        rows = torch.cat(seen).numpy()
        assert len(seen) == 7 and rows.shape == (203, 8)
        # each real row exactly once: the sorted rows are x's sorted rows
        np.testing.assert_array_equal(
            rows[np.lexsort(rows.T)], x[np.lexsort(x.T)])
        orders.append(rows[:, 0].copy())
    # a new permutation every epoch, padding rows spread over the steps
    assert not np.array_equal(orders[0], orders[1])
    assert sum(s["_count"] for s in eng.last_steps) == 203
    losses = [s["loss"] for s in est.train_summary]
    assert losses[-1] < losses[0]
    assert est.train_summary[-1]["accuracy"] > 0.8
    assert est.evaluate({"x": x, "y": y}, batch_size=33)["accuracy"] > 0.8


def test_shuffle_is_seeded_by_seed_and_epoch():
    def run(seed):
        OrcaContext.train_data_store = "DEVICE"
        x, y = _toy()
        torch.manual_seed(0)
        mlp = nn.Sequential(nn.Linear(8, 2))
        est = Estimator.from_torch(
            mlp, loss="sparse_categorical_crossentropy", learning_rate=0.05,
            seed=seed)
        est.fit({"x": x, "y": y}, epochs=2, batch_size=33, shuffle=True)
        return [s["loss"] for s in est.train_summary]
    assert run(0) == run(0)
    assert run(0) != run(1)


def test_second_fit_on_the_same_arrays_hits_the_cache():
    OrcaContext.train_data_store = "DEVICE"
    x, y = _toy()
    est = _estimator()
    est.fit({"x": x, "y": y}, epochs=1, batch_size=32, shuffle=False)
    (dds, arrays), = est._device_cache.values()
    # the sources are held beside the upload, so their ids stay theirs
    assert any(a is x for a in arrays) and any(a is y for a in arrays)
    est.fit({"x": x, "y": y}, epochs=1, batch_size=32, shuffle=False)
    assert est.device_cache_hits == 1 and len(est._device_cache) == 1
    (again, _), = est._device_cache.values()
    assert again is dds
    # another batch size is another layout: a new upload
    est.fit({"x": x, "y": y}, epochs=1, batch_size=64, shuffle=False)
    assert est.device_cache_hits == 1 and len(est._device_cache) == 2


def test_mutated_source_is_uploaded_again():
    OrcaContext.train_data_store = "DEVICE"
    x, y = _toy()
    est = _estimator()
    est.fit({"x": x, "y": y}, epochs=1, batch_size=32, shuffle=False)
    (old, _), = est._device_cache.values()
    x[0] += 10.0                    # row 0 is always sampled
    est.fit({"x": x, "y": y}, epochs=1, batch_size=32, shuffle=False)
    assert est.device_cache_hits == 0
    (new, _), = est._device_cache.values()     # the stale upload is gone
    assert new is not old
    np.testing.assert_array_equal(new.data["features"][0][0, 0].numpy(),
                                  x[0])


def test_total_cap_clears_the_cache_before_an_insert_past_it():
    OrcaContext.train_data_store = "DEVICE"
    x, y = _toy()
    est = _estimator()
    est.fit({"x": x, "y": y}, epochs=1, batch_size=32, shuffle=False)
    (dds, _), = est._device_cache.values()
    OrcaContext.device_cache_bytes = dds.nbytes + 1       # room for one
    x2 = x + 1.0
    est.fit({"x": x2, "y": y}, epochs=1, batch_size=32, shuffle=False)
    (_, arrays), = est._device_cache.values()
    assert arrays[0] is x2


def test_over_the_cap_streams_from_the_host(caplog):
    OrcaContext.train_data_store = "DEVICE"
    OrcaContext.device_cache_bytes = 1024
    x, y = _toy()
    est = _estimator()
    with caplog.at_level(logging.WARNING, "analytics_zoo_tpu_torch"):
        est.fit({"x": x, "y": y}, epochs=1, batch_size=32)
    assert "using host streaming" in caplog.text
    assert not est._device_cache and est.engine.host_step == 7


def test_shuffle_counts_the_footprint_twice(caplog):
    OrcaContext.train_data_store = "DEVICE"
    x, y = _toy()
    est = _estimator()
    est.fit({"x": x, "y": y}, epochs=1, batch_size=32, shuffle=False)
    (dds, _), = est._device_cache.values()
    OrcaContext.device_cache_bytes = dds.nbytes     # fits once, not twice
    est.fit({"x": x, "y": y}, epochs=1, batch_size=32, shuffle=False)
    assert est.device_cache_hits == 1
    with caplog.at_level(logging.WARNING, "analytics_zoo_tpu_torch"):
        est.fit({"x": x, "y": y}, epochs=1, batch_size=32, shuffle=True)
    assert "x2 for shuffle" in caplog.text and est.device_cache_hits == 1


def test_non_finite_step_on_the_device_is_skipped_and_counted(caplog):
    x, y = _toy(n=96)
    x[40] = np.nan                     # in the second of three steps
    runs = {}
    for store in ("DRAM", "DEVICE"):
        OrcaContext.train_data_store = store
        est = _estimator()
        eng = est.engine
        before = []

        def spy(batch, step=eng.train_step):
            before.append([p.detach().clone() for p in eng.params])
            return step(batch)

        eng.train_step = spy
        with caplog.at_level(logging.WARNING, "analytics_zoo_tpu_torch"):
            est.fit({"x": x, "y": y}, epochs=1, batch_size=32,
                    shuffle=False)
        stats = est.train_summary[-1]
        assert stats["nan_steps"] == 1.0
        assert [s["_count"] for s in eng.last_steps] == [32.0, 0.0, 32.0]
        # the skipped step left every parameter as it found it
        for a, b in zip(before[1], before[2]):
            assert torch.equal(a, b)
        runs[store] = (eng.last_steps, [p.detach() for p in eng.params])
    assert "were skipped" in caplog.text
    assert runs["DEVICE"][0] == runs["DRAM"][0]
    for a, b in zip(runs["DEVICE"][1], runs["DRAM"][1]):
        assert torch.equal(a, b)
