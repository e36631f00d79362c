"""The port's XShards (analytics_zoo_tpu_torch/orca/data/shard.py) held
against the JAX package's (analytics_zoo_tpu/orca/data/shard.py) on the
same numpy data, every method under both storage tiers (DRAM, and DISK,
where the shards are pickled to a temp dir).  Shards are compared
exactly: both sides split, concatenate and sample with numpy (the
samplers from the same `SeedSequence` spawn), so every array must be
equal bit for bit, with the same structure and dtypes.

Also: the DISK tier's spill directory is removed once the XShards is
freed, and `analytics_zoo_tpu_torch.orca.data` with `XShards.partition`
of ndarray dicts (and a fit from it) runs in an interpreter where
pandas cannot be imported."""

import gc
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from analytics_zoo_tpu.common.context import OrcaContext as JaxContext
from analytics_zoo_tpu.orca.data import XShards as JaxXShards
from analytics_zoo_tpu.orca.data import shard as jax_shard
from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.orca.data import XShards
from analytics_zoo_tpu_torch.orca.data import shard as port_shard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(params=["DRAM", "DISK_2"])
def tier(request):
    prev = (OrcaContext.train_data_store, JaxContext.train_data_store,
            OrcaContext.shard_size, JaxContext.shard_size)
    OrcaContext.train_data_store = JaxContext.train_data_store = \
        request.param
    yield request.param
    (OrcaContext.train_data_store, JaxContext.train_data_store,
     OrcaContext.shard_size, JaxContext.shard_size) = prev


def same(got, want, path="shard"):
    """Equal structure, types, dtypes and values, exactly."""
    if isinstance(want, pd.DataFrame):
        assert isinstance(got, pd.DataFrame), path
        pd.testing.assert_frame_equal(got, want)
        return
    assert type(got) is type(want), f"{path}: {type(got)} != {type(want)}"
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for j, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{path}[{j}]")
    else:
        assert got == want, path


def same_shards(got, want):
    assert got.num_partitions() == want.num_partitions()
    same(got.collect(), want.collect())
    for i in range(want.num_partitions()):
        same(got.get_shard(i), want.get_shard(i), f"shard {i}")


def _data(n=37, seed=0):
    rng = np.random.default_rng(seed)
    return {"x": [rng.integers(0, 9, n).astype(np.int32),
                  rng.normal(size=(n, 3)).astype(np.float32)],
            "y": (rng.integers(0, 2, n).astype(np.int64),)}


def _frame(n=23, seed=1):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"k": rng.integers(0, 5, n), "v": rng.normal(size=n),
                         "s": [f"r{j % 4}" for j in range(n)]})


@pytest.mark.parametrize("num_shards,shard_size",
                         [(None, None), (3, None), (50, None), (None, 10)])
def test_partition_matches_jax(tier, num_shards, shard_size):
    OrcaContext.shard_size = JaxContext.shard_size = shard_size
    data = _data()
    same_shards(XShards.partition(data, num_shards),
                JaxXShards.partition(data, num_shards))
    arr = np.arange(12.0).reshape(6, 2)
    same_shards(XShards.partition(arr, num_shards),
                JaxXShards.partition(arr, num_shards))


def test_partition_rejects_as_jax_does(tier):
    for bad in ({}, {"x": np.zeros(3), "y": np.zeros(4)}):
        with pytest.raises(ValueError) as want:
            JaxXShards.partition(bad)
        with pytest.raises(ValueError) as got:
            XShards.partition(bad)
        assert str(got.value) == str(want.value)


def test_transform_shard_matches_jax(tier):
    data = _data()

    def f(s, k):
        return {"x": [s["x"][0] * k, s["x"][1] + 1], "y": s["y"]}

    port = XShards.partition(data, 5).transform_shard(f, 3)
    same_shards(port, JaxXShards.partition(data, 5).transform_shard(f, 3))
    # more shards than twice the pool: the bounded map keeps the order
    many = np.arange(300)
    same_shards(XShards.partition(many, 100).transform_shard(lambda s: -s),
                JaxXShards.partition(many, 100).transform_shard(
                    lambda s: -s))


def test_transform_shard_with_index_matches_jax(tier):
    data = _data()

    def f(i, s):
        return {"x": s["x"], "y": (s["y"][0] + 10 * i,)}

    same_shards(XShards.partition(data, 4).transform_shard_with_index(f),
                JaxXShards.partition(data, 4).transform_shard_with_index(f))


@pytest.mark.parametrize("records,num_shards",
                         [(list(range(11)), None), (list(range(11)), 3),
                          (list(range(3)), 8), ([], None)])
def test_from_records_matches_jax(tier, records, num_shards):
    same_shards(XShards.from_records(records, num_shards),
                JaxXShards.from_records(records, num_shards))


def test_repartition_matches_jax(tier):
    data = _data()
    same_shards(XShards.partition(data, 3).repartition(5),
                JaxXShards.partition(data, 3).repartition(5))
    df = _frame()
    parts = [df.iloc[:7], df.iloc[7:]]
    same_shards(XShards(parts).repartition(4), JaxXShards(parts).repartition(4))
    lists = [[1, 2], [3], [4, 5, 6], [7]]
    same_shards(XShards(lists).repartition(3),
                JaxXShards(lists).repartition(3))


def test_partition_by_and_unique_match_jax(tier):
    df = _frame()
    parts = [df.iloc[:9], df.iloc[9:]]
    for n in (None, 3, 8):
        same_shards(XShards(parts).partition_by("k", n),
                    JaxXShards(parts).partition_by("k", n))
    for col in (None, "k", "s"):
        same(XShards(parts).unique(col), JaxXShards(parts).unique(col))
    data = {"a": np.array([3, 1, 3]), "b": np.array([2.0, 2.0, 5.0])}
    same(XShards([data, data]).unique("a"), JaxXShards([data, data]).unique("a"))
    with pytest.raises(ValueError, match="DataFrame shards"):
        XShards.partition(np.arange(4)).partition_by("k")


def test_split_and_zip_match_jax(tier):
    a, b = np.arange(10), np.arange(10) * 10
    port = XShards.partition(a, 2).zip(XShards.partition(b, 2))
    want = JaxXShards.partition(a, 2).zip(JaxXShards.partition(b, 2))
    same_shards(port, want)
    for got, w in zip(port.split(), want.split()):
        same_shards(got, w)
    with pytest.raises(ValueError, match="equal num_partitions"):
        XShards.partition(a, 2).zip(XShards.partition(b, 3))
    with pytest.raises(ValueError, match="same length"):
        XShards([(1, 2), (3,)]).split()


@pytest.mark.parametrize("seed", [0, 7])
def test_sample_matches_jax(tier, seed):
    data = _data(n=60)
    same_shards(XShards.partition(data, 4).sample(0.3, seed),
                JaxXShards.partition(data, 4).sample(0.3, seed))
    df = _frame(n=40)
    parts = [df.iloc[:20], df.iloc[20:]]
    same_shards(XShards(parts).sample(0.5, seed),
                JaxXShards(parts).sample(0.5, seed))


def test_len_merged_and_to_pandas_match_jax(tier):
    data = _data()
    port, want = XShards.partition(data, 4), JaxXShards.partition(data, 4)
    assert len(port) == len(want) == 37
    same(port.merged(), want.merged())
    df = _frame()
    parts = [df.iloc[:5], df.iloc[5:]]
    assert len(XShards(parts)) == len(JaxXShards(parts)) == 23
    same(XShards(parts).to_pandas(), JaxXShards(parts).to_pandas())
    same(XShards(parts).merged(), JaxXShards(parts).merged())
    lists = [[1, 2], 3, [4]]
    same(XShards(lists).merged(), JaxXShards(lists).merged())


def test_save_and_load_pickle_match_jax(tier, tmp_path):
    data = _data()
    XShards.partition(data, 3).save_pickle(str(tmp_path / "port"))
    JaxXShards.partition(data, 3).save_pickle(str(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax"))
    same_shards(XShards.load_pickle(str(tmp_path / "port")),
                JaxXShards.load_pickle(str(tmp_path / "jax")))
    # each side reads the other's files
    same_shards(XShards.load_pickle(str(tmp_path / "jax")),
                JaxXShards.load_pickle(str(tmp_path / "port")))


def test_from_sources_is_lazy_and_matches_jax(tier):
    calls = []

    def loader(src):
        calls.append(src)
        return {"x": np.arange(src, src + 3), "y": np.full(3, src)}

    port = XShards.from_sources([0, 10, 20], loader)
    want = JaxXShards.from_sources([0, 10, 20], loader)
    assert not calls
    same_shards(port, want)
    # a transform composes with the loader and stays lazy
    n = len(calls)
    port2 = port.transform_shard(lambda s: {"x": s["x"] * 2, "y": s["y"]})
    idx = port.transform_shard_with_index(
        lambda i, s: {"x": s["x"] + i, "y": s["y"]})
    assert len(calls) == n
    assert isinstance(port2._store, port_shard._LazySourceStore)
    same_shards(port2, want.transform_shard(
        lambda s: {"x": s["x"] * 2, "y": s["y"]}))
    same_shards(idx, want.transform_shard_with_index(
        lambda i, s: {"x": s["x"] + i, "y": s["y"]}))


def test_disk_tier_spills_and_cleans_up(tier):
    xs = XShards.partition(_data(), 4)
    store = xs._store
    if tier == "DRAM":
        assert not store._disk
        return
    spill = store._dir
    assert sorted(os.listdir(spill)) == [f"shard_{i}.pkl" for i in range(4)]
    # a transform spills its results to a directory of its own
    doubled = xs.transform_shard(lambda s: s)
    assert doubled._store._dir != spill
    same_shards(doubled, xs)
    del xs, store, doubled
    gc.collect()
    assert not os.path.exists(spill)


def test_flatten_and_concat_match_jax():
    data = {"a": [np.arange(4), (np.ones((4, 2)), np.zeros(4, np.int8))],
            "b": np.arange(4.0), "c": (np.array([1, 2, 3, 4]),)}
    leaves, rebuild = port_shard._flatten(data)
    want_leaves, want_rebuild = jax_shard._flatten(data)
    same(leaves, want_leaves)
    same(rebuild(leaves), want_rebuild(want_leaves))
    shards = [port_shard._flatten(data)[1]([a[:2] for a in leaves]),
              port_shard._flatten(data)[1]([a[2:] for a in leaves])]
    same(port_shard._concat_shards(shards), jax_shard._concat_shards(shards))


_NO_PANDAS = r"""
import sys
sys.modules["pandas"] = None        # any import of pandas now fails
import numpy as np
import analytics_zoo_tpu_torch.orca.data as data
from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.orca.data import XShards
from analytics_zoo_tpu_torch.orca.learn import Estimator
import torch
rng = np.random.default_rng(0)
u, y = rng.integers(0, 9, 50), rng.integers(0, 2, 50)
for tier in ("DRAM", "DISK_2"):
    OrcaContext.train_data_store = tier
    xs = XShards.partition({"x": [u], "y": y}, num_shards=3)
    xs = xs.repartition(4).transform_shard(lambda s: s)
    assert len(xs) == 50 and xs.num_partitions() == 4
    assert xs.unique("y").tolist() == [0, 1]
    model = torch.nn.Sequential(torch.nn.Embedding(9, 4),
                                torch.nn.Linear(4, 2))
    est = Estimator.from_torch(model, loss="sparse_categorical_crossentropy")
    est.fit(xs, epochs=1, batch_size=16)
    assert est.engine.host_step == 4
    assert est.predict(xs, batch_size=16).shape == (50, 2)
print("OK", sys.modules["pandas"])
"""


def test_data_path_runs_without_pandas():
    """A fresh interpreter where `import pandas` fails: the package, the
    partition, the DISK tier, a repartition of arrays and a streamed fit
    all run."""
    out = subprocess.run([sys.executable, "-c", _NO_PANDAS], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "OK None"


def test_importing_the_data_package_loads_no_pandas():
    code = ("import sys, numpy as np\n"
            "from analytics_zoo_tpu_torch.orca.data import XShards\n"
            "XShards.partition({'x': np.arange(8), 'y': np.arange(8)}, 2)\n"
            "print('pandas' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "False"
