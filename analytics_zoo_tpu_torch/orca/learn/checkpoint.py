"""Checkpoint / resume (counterpart of
analytics_zoo_tpu/orca/learn/checkpoint.py, with `torch.save` in place
of orbax).

Every save goes through one atomic commit protocol, `write_committed`:

    1. `torch.save` the state's host tensors into `state.pt` inside a
       hidden sibling temp dir, flushed and fsynced,
    2. `os.replace` the temp dir onto the final path,
    3. write the epoch/step sidecar (`<path>.meta.json`), then the
       commit marker (`<path>.commit`, itself written temp -> rename and
       fsynced).

`find_latest_checkpoint` trusts only the marker: a crash at any point
before step 3 leaves an invisible temp dir or a marker-less directory,
and both are skipped.  The JAX package also accepts marker-less
directories written by plain orbax (`_is_committed_legacy`); the port
never wrote one, so it has no such fallback.

The payload is a nested dict of CPU tensors and plain values, read back
with `torch.load(weights_only=True)`.  Background saves run through
`resilience.checkpointing.BackgroundCheckpointer`: the caller's thread
snapshots the state to host tensors (`host_snapshot`) and the writer
thread runs `write_committed` over them, making no CUDA call.  Async is
the default for a state on the card and sync for one on the CPU
(`async_save_enabled`); `ZOO_ASYNC_CHECKPOINT=0|1` overrides.
Transient I/O errors retry under a deterministic `RetryPolicy`.

Fault-injection sites: `checkpoint.before_write` / `mid_write` /
`before_rename` / `before_commit` / `after_commit` / `load`.
"""

from __future__ import annotations

import atexit
import json
import os
import re
import shutil
import time
from typing import Any, Dict, Optional

import torch

from analytics_zoo_tpu_torch.resilience.faults import fault_point
from analytics_zoo_tpu_torch.resilience.retry import RetryPolicy

#: marker suffix of the commit protocol; the marker's presence is the
#: definition of "this checkpoint is durable"
COMMIT_SUFFIX = ".commit"
#: the payload file inside a checkpoint directory
PAYLOAD = "state.pt"

#: transient-I/O retry for the payload write and read (OSError only: a
#: corrupt checkpoint must fail loudly)
_IO_RETRY = RetryPolicy(max_attempts=3, backoff_s=0.1,
                        name="checkpoint_io")

_tmp_counter = 0


def _map_tensors(state, fn):
    if torch.is_tensor(state):
        return fn(state)
    if isinstance(state, dict):
        return type(state)((k, _map_tensors(v, fn)) for k, v in state.items())
    if isinstance(state, (list, tuple)):
        return type(state)(_map_tensors(v, fn) for v in state)
    return state


def host_snapshot(state):
    """`state` with every tensor copied to host memory: a CUDA tensor
    read back, a host tensor cloned, so the training loop's later
    in-place updates cannot reach the copy."""
    return _map_tensors(state, lambda t: t.detach().to("cpu", copy=True))


def _device_of(state) -> torch.device:
    """The first non-CPU device a tensor of `state` lives on, else cpu."""
    found = []

    def look(t):
        if t.device.type != "cpu" and not found:
            found.append(t.device)
        return t
    _map_tensors(state, look)
    return found[0] if found else torch.device("cpu")


def async_save_enabled(device=None) -> bool:
    """True when unqualified saves of a state on `device` run in the
    background: off the CPU (a device-to-host copy is the only cost the
    caller pays), never on it (the JAX package's gate, CI determinism);
    `ZOO_ASYNC_CHECKPOINT` overrides."""
    env = os.environ.get("ZOO_ASYNC_CHECKPOINT")
    if env is not None:
        return env.strip().lower() not in ("0", "false", "")
    return device is not None and torch.device(device).type != "cpu"


def wait_for_checkpoints():
    """Block until any in-flight background save has committed.  Called
    before every restore (read-your-write) and at interpreter exit.
    Write failures do not raise here; `BackgroundCheckpointer.drain()`
    is where a failed write surfaces."""
    from analytics_zoo_tpu_torch.resilience.checkpointing import (
        drain_background,
    )
    drain_background(raise_on_error=False)


atexit.register(wait_for_checkpoints)


def _atomic_write_json(path: str, payload: Dict[str, Any]) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def write_committed(path: str, state,
                    meta: Optional[Dict[str, Any]] = None) -> str:
    """The atomic commit protocol (module docstring).  `state` may hold
    device tensors (the sync path: they are read back here) or be a
    host snapshot (the background writer).  Returns `path`, durable on
    return."""
    global _tmp_counter
    path = os.path.abspath(path)
    parent, name = os.path.split(path)
    os.makedirs(parent, exist_ok=True)
    fault_point("checkpoint.before_write", path=path)
    # sweep the temp leftovers of crashed earlier saves of this target
    for stale in os.listdir(parent):
        if stale.startswith(f".tmp-{name}-"):
            shutil.rmtree(os.path.join(parent, stale), ignore_errors=True)
    _tmp_counter += 1
    tmp = os.path.join(parent, f".tmp-{name}-{os.getpid()}-{_tmp_counter}")
    if _device_of(state).type != "cpu":
        state = _map_tensors(state, lambda t: t.detach().cpu())

    def write():
        os.makedirs(tmp, exist_ok=True)
        with open(os.path.join(tmp, PAYLOAD), "wb") as f:
            torch.save(state, f)
            f.flush()
            os.fsync(f.fileno())

    _IO_RETRY.run(write, retryable=(OSError,))
    fault_point("checkpoint.mid_write", path=tmp)
    fault_point("checkpoint.before_rename", path=path)
    if os.path.isdir(path):
        # overwrite: un-commit before destroying the old version, so a
        # crash between these steps leaves the path marker-less, never
        # marked but torn
        if os.path.exists(path + COMMIT_SUFFIX):
            os.remove(path + COMMIT_SUFFIX)
        shutil.rmtree(path)
    os.replace(tmp, path)
    fault_point("checkpoint.before_commit", path=path)
    if meta is not None:
        _atomic_write_json(path + ".meta.json", dict(meta))
    _atomic_write_json(path + COMMIT_SUFFIX,
                       {"name": name, "wall_time": time.time(),
                        **({"meta": dict(meta)} if meta else {})})
    fault_point("checkpoint.after_commit", path=path)
    return path


def save_checkpoint(path: str, state, block: Optional[bool] = None,
                    meta: Optional[Dict[str, Any]] = None) -> str:
    """Write `state` to `path` through the commit protocol.
    `block=None` takes `async_save_enabled` for the state's device.

    On the background path the returned path is not yet durable: the
    marker lands on the writer thread.  Readers in this process are
    covered (`load_checkpoint` and `find_latest_checkpoint` drain
    first); before handing the path to another process, call
    `wait_for_checkpoints()` (or `drain()` on the writer, which also
    raises a failed write)."""
    path = os.path.abspath(path)
    if block is None:
        block = not async_save_enabled(_device_of(state))
    if block:
        return write_committed(path, state, meta=meta)
    from analytics_zoo_tpu_torch.resilience.checkpointing import (
        get_background_checkpointer,
    )
    return get_background_checkpointer().submit(path, state, meta=meta)


def load_checkpoint(path: str):
    """The state saved at `path`, as host tensors (the caller moves
    them where they belong: `TrainEngine.load_state_dict`)."""
    wait_for_checkpoints()          # read-your-write for async saves
    path = os.path.abspath(path)
    fault_point("checkpoint.load", path=path)
    return _IO_RETRY.run(
        lambda: torch.load(os.path.join(path, PAYLOAD), map_location="cpu",
                           weights_only=True),
        retryable=(OSError,))


def has_commit_marker(path: str) -> bool:
    """Marker and directory: a marker whose directory vanished is not a
    loadable commit."""
    return os.path.isfile(path + COMMIT_SUFFIX) and os.path.isdir(path)


def find_latest_checkpoint(model_dir: str,
                           version: Optional[int] = None) -> str:
    """The newest committed `ckpt-N` under `model_dir` (marker-less
    candidates are uncommitted and skipped), or `ckpt-<version>`."""
    wait_for_checkpoints()          # an in-flight save is the latest
    pat = re.compile(r"^ckpt-(\d+)$")
    candidates = []
    for name in os.listdir(model_dir):
        m = pat.match(name)
        if m:
            candidates.append((int(m.group(1)),
                               os.path.join(model_dir, name)))
    if not candidates:
        raise FileNotFoundError(f"no checkpoints under {model_dir}")
    if version is not None:
        for v, p in candidates:
            if v == version:
                return p
        raise FileNotFoundError(f"no checkpoint version {version}")
    committed = [c for c in candidates if has_commit_marker(c[1])]
    if not committed:
        raise FileNotFoundError(
            f"only uncommitted (torn) checkpoints under {model_dir}: "
            f"{sorted(p for _, p in candidates)}")
    return max(committed)[1]
