"""File readers to XShards (counterpart of
analytics_zoo_tpu/orca/data/pandas/preprocessing.py).

Each file becomes one shard, read on a thread pool.  Where
`torch.distributed` is initialized, process i of a world of H takes
files i, i+H, i+2H, ... (or, with fewer files than processes, every
file and a row stride of each); otherwise the process is (0, 1), the
JAX package's single-host case.  pandas is imported by the readers
alone, never at import time.
"""

from __future__ import annotations

import glob
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

from analytics_zoo_tpu_torch.orca.data.shard import XShards, _pool_size


def _process() -> Tuple[int, int]:
    """(rank, world size) of `torch.distributed`, or (0, 1)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _list_files(path: str, ext: str) -> List[str]:
    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, f"*{ext}")))
        if not files:  # every file in the directory instead
            files = sorted(
                os.path.join(path, f) for f in os.listdir(path)
                if not f.startswith(("_", ".")))
    elif any(c in path for c in "*?["):
        files = sorted(glob.glob(path))
    else:
        files = [path]
    if not files:
        raise FileNotFoundError(f"no input files at {path}")
    return files


def _read(path: str, ext: str, reader, num_shards=None, **kwargs) -> XShards:
    files = _list_files(path, ext)
    # with enough files each process takes a stride of them; with fewer
    # files than processes each reads every file and takes a row stride,
    # so no row is read twice
    idx, n_procs = _process()
    row_stride = n_procs > len(files)
    if not row_stride:
        files = files[idx::n_procs]

    with ThreadPoolExecutor(_pool_size()) as ex:
        dfs = list(ex.map(lambda f: reader(f, **kwargs), files))
    if row_stride:
        dfs = [df.iloc[idx::n_procs] for df in dfs]

    shards = XShards(dfs)
    if num_shards and num_shards != len(dfs):
        shards = shards.repartition(num_shards)
    elif len(dfs) == 1 and num_shards is None:
        # one file: split it for the parallel transforms
        n = min(_pool_size(), max(1, len(dfs[0])))
        if n > 1:
            shards = shards.repartition(n)
    return shards


def read_csv(file_path: str, num_shards=None, **kwargs) -> XShards:
    import pandas as pd
    return _read(file_path, ".csv", pd.read_csv, num_shards, **kwargs)


def read_json(file_path: str, num_shards=None, **kwargs) -> XShards:
    import pandas as pd
    return _read(file_path, ".json", pd.read_json, num_shards, **kwargs)


def read_parquet(file_path: str, num_shards=None, **kwargs) -> XShards:
    import pandas as pd
    return _read(file_path, ".parquet", pd.read_parquet, num_shards, **kwargs)
