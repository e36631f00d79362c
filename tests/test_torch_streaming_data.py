"""The port's host data path (analytics_zoo_tpu_torch/orca/learn/utils.py
and orca/data/pandas/) held against the JAX package's on the same numpy
data: streamed XShards batches against JAX's `_StreamingHostDataset`,
DataFrame input through `feature_cols` / `label_cols` (columns of
arrays included), and the CSV, JSON and parquet readers.

Every comparison is exact: both sides are numpy from the same
generators (`np.random.default_rng(seed + epoch)` for the shard order
and then each shard's rows), so each batch, its padding and its mask
must be equal bit for bit.  JAX pads to `pad_to_multiple_of` for its
mesh; the port has one card, so JAX runs with 1 here."""

import threading
import time

import numpy as np
import pandas as pd
import pytest

from analytics_zoo_tpu.common.context import OrcaContext as JaxContext
from analytics_zoo_tpu.orca.data import XShards as JaxXShards
from analytics_zoo_tpu.orca.data import pandas as jax_pandas
from analytics_zoo_tpu.orca.learn.utils import HostDataset as JaxHostDataset
from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.orca.data import XShards
from analytics_zoo_tpu_torch.orca.data import pandas as port_pandas
from analytics_zoo_tpu_torch.orca.learn.utils import (
    HostDataset,
    _StreamingHostDataset,
)


@pytest.fixture(params=["DRAM", "DISK_2"])
def tier(request):
    prev = OrcaContext.train_data_store, JaxContext.train_data_store
    OrcaContext.train_data_store = JaxContext.train_data_store = \
        request.param
    yield request.param
    OrcaContext.train_data_store, JaxContext.train_data_store = prev


def same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for key in ("features", "labels"):
            assert len(g[key]) == len(w[key])
            for a, b in zip(g[key], w[key]):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
        assert g["mask"].dtype == w["mask"].dtype == np.float32
        np.testing.assert_array_equal(g["mask"], w["mask"])
    return got


def _shards(rng, sizes):
    """Dict shards of the given row counts (0 is an empty shard)."""
    out = []
    for n in sizes:
        out.append({"x": [rng.integers(0, 100, n).astype(np.int32),
                          rng.normal(size=(n, 3)).astype(np.float32)],
                    "y": rng.integers(0, 2, n).astype(np.int32)})
    return out


SIZES = [23, 0, 40, 7, 31, 18]     # 119 rows, an empty shard


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("batch", [16, 25, 200])
def test_streamed_batches_equal_jax(tier, shuffle, batch):
    """Two epochs, with carry-over across shard edges, an empty shard
    and a padded last batch."""
    shards = _shards(np.random.default_rng(0), SIZES)
    port = HostDataset.from_data(XShards(shards))
    want = JaxHostDataset.from_data(JaxXShards(shards))
    assert isinstance(port, _StreamingHostDataset)
    for epoch in (0, 1):
        got = same_batches(
            port.batches(batch, shuffle=shuffle, seed=3, epoch=epoch),
            want.batches(batch, shuffle=shuffle, seed=3, epoch=epoch,
                         pad_to_multiple_of=1))
        assert sum(int(b["mask"].sum()) for b in got) == sum(SIZES)
    assert port.n == want.n == sum(SIZES)
    assert port.steps_per_epoch(batch) == want.steps_per_epoch(batch)


def test_streamed_epochs_differ_and_cover_every_row(tier):
    shards = _shards(np.random.default_rng(1), SIZES)
    ds = HostDataset.from_data(XShards(shards))
    firsts = []
    for epoch in (0, 1):
        rows = [b["features"][0][b["mask"] > 0]
                for b in ds.batches(16, shuffle=True, seed=0, epoch=epoch)]
        firsts.append(rows[0])
        np.testing.assert_array_equal(
            np.sort(np.concatenate(rows)),
            np.sort(np.concatenate([s["x"][0] for s in shards])))
    assert not np.array_equal(firsts[0], firsts[1])


def test_unshuffled_stream_equals_the_array_path(tier):
    """Re-chunking is exact: the same rows in the same order as the
    merged arrays' batches."""
    shards = _shards(np.random.default_rng(2), SIZES)
    merged = XShards(shards).merged()
    same_batches(HostDataset.from_data(XShards(shards)).batches(16),
                 HostDataset.from_data(merged).batches(16))


def test_probe_and_head_match_jax(tier):
    shards = _shards(np.random.default_rng(3), [5, 9])
    port = HostDataset.from_data(XShards(shards))
    want = JaxHostDataset.from_data(JaxXShards(shards))
    same_batches([port.probe(4), port.probe(64)],
                 [want.probe(4), want.probe(64)])
    assert port.has_labels and want.has_labels
    arrays = HostDataset.from_data(shards[1])
    same_batches([arrays.probe(4)],
                 [JaxHostDataset.from_data(shards[1]).probe(4)])


@pytest.mark.parametrize("kind", ["tuple", "bare"])
def test_tuple_and_bare_shards_match_jax(tier, kind):
    rng = np.random.default_rng(4)
    shards = []
    for n in (6, 11):
        x, y = rng.normal(size=(n, 2)).astype(np.float32), np.arange(n)
        shards.append((x, y) if kind == "tuple" else x)
    port = HostDataset.from_data(XShards(shards))
    want = JaxHostDataset.from_data(JaxXShards(shards))
    same_batches(port.batches(4, shuffle=True, seed=1),
                 want.batches(4, shuffle=True, seed=1))
    assert port.has_labels == want.has_labels == (kind == "tuple")


def _loader_threads():
    return [t for t in threading.enumerate() if t.name == "xshards-loader"]


def test_abandoned_epoch_stops_the_loader(tier):
    """A consumer that stops after one batch: closing the generator
    sets the stop event, and the loader exits though the queue is
    full."""
    shards = _shards(np.random.default_rng(5), [10] * 12)
    ds = HostDataset.from_data(XShards(shards))
    before = len(_loader_threads())
    it = ds.batches(4)
    next(it)
    time.sleep(0.3)                 # the loader fills its queue and waits
    assert len(_loader_threads()) == before + 1
    it.close()
    deadline = time.time() + 5
    while len(_loader_threads()) > before and time.time() < deadline:
        time.sleep(0.05)
    assert len(_loader_threads()) == before


def test_loader_errors_reach_the_consumer(tier):
    def loader(src):
        if src == 2:
            raise OSError("part-2 unreadable")
        return {"x": np.arange(3), "y": np.arange(3)}

    ds = HostDataset.from_data(XShards.from_sources(range(4), loader))
    with pytest.raises(OSError, match="part-2"):
        list(ds.batches(2))
    assert not _loader_threads()


def _frame(rng, n):
    return pd.DataFrame({
        "user": rng.integers(1, 50, n), "item": rng.integers(1, 30, n),
        "emb": [rng.normal(size=4).astype(np.float32) for _ in range(n)],
        "label": rng.integers(0, 2, n).astype(np.int32)})


@pytest.mark.parametrize("label_cols", [["label"], None])
def test_dataframe_input_matches_jax(label_cols):
    """A DataFrame with a column of arrays (stacked to [rows, 4])."""
    df = _frame(np.random.default_rng(6), 37)
    cols = ["user", "item", "emb"]
    port = HostDataset.from_data(df, cols, label_cols)
    want = JaxHostDataset.from_data(df, cols, label_cols)
    assert port.features[2].shape == (37, 4)
    assert port.has_labels == want.has_labels == bool(label_cols)
    same_batches(port.batches(10, shuffle=True, seed=2),
                 want.batches(10, shuffle=True, seed=2))
    with pytest.raises(ValueError, match="feature_cols required"):
        HostDataset.from_data(df)


def test_dataframe_shards_match_jax(tier):
    df = _frame(np.random.default_rng(7), 50)
    parts = [df.iloc[:12], df.iloc[12:41], df.iloc[41:]]
    cols = ["user", "item", "emb"]
    port = HostDataset.from_data(XShards(parts), cols, ["label"])
    want = JaxHostDataset.from_data(JaxXShards(parts), cols, ["label"])
    for epoch in (0, 1):
        same_batches(port.batches(16, shuffle=True, seed=5, epoch=epoch),
                     want.batches(16, shuffle=True, seed=5, epoch=epoch))
    with pytest.raises(ValueError, match="feature_cols required"):
        list(HostDataset.from_data(XShards(parts)).batches(4))


def test_callable_input_matches_jax():
    rng = np.random.default_rng(8)
    x, y = rng.normal(size=(9, 2)).astype(np.float32), np.arange(9)
    same_batches(HostDataset.from_data(lambda: {"x": x, "y": y}).batches(4),
                 JaxHostDataset.from_data(lambda: {"x": x, "y": y}).batches(4))
    shards = _shards(rng, [5, 6])
    same_batches(HostDataset.from_data(lambda: XShards(shards)).batches(4),
                 JaxHostDataset.from_data(
                     lambda: JaxXShards(shards)).batches(4))


def _write(tmp_path, ext, n_files, rows=9):
    rng = np.random.default_rng(9)
    for j in range(n_files):
        df = pd.DataFrame({"a": rng.integers(0, 100, rows),
                           "b": rng.normal(size=rows)})
        path = tmp_path / f"part{j}{ext}"
        if ext == ".csv":
            df.to_csv(path, index=False)
        elif ext == ".json":
            df.to_json(path)
        else:
            df.to_parquet(path)
    return str(tmp_path)


@pytest.mark.parametrize("ext,reader", [(".csv", "read_csv"),
                                        (".json", "read_json"),
                                        (".parquet", "read_parquet")])
@pytest.mark.parametrize("n_files,num_shards", [(3, None), (1, None),
                                                (3, 2), (1, 5)])
def test_readers_match_jax(tier, tmp_path, ext, reader, n_files, num_shards):
    path = _write(tmp_path, ext, n_files)
    port = getattr(port_pandas, reader)(path, num_shards=num_shards)
    want = getattr(jax_pandas, reader)(path, num_shards=num_shards)
    assert port.num_partitions() == want.num_partitions()
    for g, w in zip(port.collect(), want.collect()):
        pd.testing.assert_frame_equal(g, w)
    pd.testing.assert_frame_equal(port.to_pandas(), want.to_pandas())
    # a glob and a single file name give the same files
    one = getattr(port_pandas, reader)(f"{path}/part0{ext}")
    pd.testing.assert_frame_equal(
        one.to_pandas(),
        getattr(jax_pandas, reader)(f"{path}/part0{ext}").to_pandas())
    glob_ = getattr(port_pandas, reader)(f"{path}/part*{ext}")
    pd.testing.assert_frame_equal(glob_.to_pandas(), want.to_pandas()
                                  if num_shards is None else
                                  getattr(jax_pandas, reader)(
                                      f"{path}/part*{ext}").to_pandas())


def test_reader_without_files_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        port_pandas.read_csv(str(tmp_path / "none*.csv"))


@pytest.mark.parametrize("n_files", [5, 2])
def test_readers_take_the_process_stride_as_jax_does(tmp_path, monkeypatch,
                                                     n_files):
    """Process 1 of 3: a stride of the files where there are enough, a
    row stride of every file otherwise; JAX's host index and count
    against `torch.distributed`'s rank and world size."""
    import jax
    from analytics_zoo_tpu_torch.orca.data.pandas import preprocessing
    path = _write(tmp_path, ".csv", n_files)
    monkeypatch.setattr(jax, "process_index", lambda: 1)
    monkeypatch.setattr(jax, "process_count", lambda: 3)
    monkeypatch.setattr(preprocessing, "_process", lambda: (1, 3))
    port, want = port_pandas.read_csv(path), jax_pandas.read_csv(path)
    assert port.num_partitions() == want.num_partitions()
    pd.testing.assert_frame_equal(port.to_pandas(), want.to_pandas())
    assert len(port.to_pandas()) == (2 * 9 if n_files == 5 else 2 * 3)


def test_reader_process_is_torch_distributed_rank_and_size():
    import socket

    import torch.distributed as dist
    from analytics_zoo_tpu_torch.orca.data.pandas import preprocessing
    assert preprocessing._process() == (0, 1)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        assert preprocessing._process() == (0, 1)
    finally:
        dist.destroy_process_group()
