"""Background checkpointing off the training critical path (counterpart
of analytics_zoo_tpu/resilience/checkpointing.py).

The critical-path cost of a save becomes one snapshot of the state to
host tensors, taken on the caller's thread (`checkpoint.host_snapshot`:
each CUDA tensor copied to host memory, each host tensor cloned, so
later in-place updates cannot reach the snapshot).  Serialization, the
atomic temp -> rename -> commit-marker protocol
(`orca/learn/checkpoint.py`: `write_committed`) and fsync run on a
daemon writer thread over host tensors only: the writer makes no CUDA
call, so it needs no CUDA context of its own.

At most one save is in flight: a new `submit` drains the previous,
`drain()` blocks until durable and re-raises a failed background write
as `CheckpointWriteError`, and `checkpoint.wait_for_checkpoints()`
drains the process-global writer, so `find_latest_checkpoint` and
`load_checkpoint` read their own writes.  `last_snapshot_s` and
`last_write_s` hold the latest save's snapshot time (critical path) and
its writer-thread wall time; a failed write leaves a
``checkpoint_write_failed`` flight record and event.
"""

from __future__ import annotations

import atexit
import logging
import threading
from typing import Any, Dict, Optional

from analytics_zoo_tpu_torch.observability import (
    flight_recorder,
    log_event,
    now,
)

logger = logging.getLogger("analytics_zoo_tpu_torch")


class CheckpointWriteError(RuntimeError):
    """A background checkpoint write failed; surfaced on the next
    `drain()` so the failure cannot silently cost the restore point."""


class BackgroundCheckpointer:
    """One writer thread, one in-flight save, crash-consistent commits."""

    def __init__(self):
        #: held from one submit's drain to its enqueue, so two threads'
        #: submits cannot both find the writer idle and drop a save
        self._submit_lock = threading.Lock()
        self._lock = threading.Lock()
        self._idle = threading.Event()
        self._idle.set()
        self._pending: Optional[tuple] = None
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._wake = threading.Event()
        self._stop = False
        self.last_snapshot_s: Optional[float] = None
        self.last_write_s: Optional[float] = None

    def submit(self, path: str, state: Any,
               meta: Optional[Dict[str, Any]] = None) -> str:
        """Snapshot `state` to host tensors and queue the committed
        write.  Returns `path` at once; it is durable only after the
        commit marker lands (`drain()` to wait)."""
        from analytics_zoo_tpu_torch.orca.learn.checkpoint import (
            host_snapshot,
        )
        with self._submit_lock:
            self.drain()                 # one in-flight save at most
            t0 = now()
            snapshot = host_snapshot(state)
            self.last_snapshot_s = now() - t0
            with self._lock:
                self._pending = (path, snapshot, meta)
                self._idle.clear()
                if self._thread is None:
                    self._thread = threading.Thread(
                        target=self._writer, daemon=True,
                        name="background-checkpointer")
                    self._thread.start()
            self._wake.set()
        return path

    def _writer(self) -> None:
        from analytics_zoo_tpu_torch.orca.learn.checkpoint import (
            write_committed,
        )
        while True:
            self._wake.wait()
            self._wake.clear()
            if self._stop:
                return
            with self._lock:
                job, self._pending = self._pending, None
            if job is None:
                continue
            path, snapshot, meta = job
            t0 = now()
            try:
                write_committed(path, snapshot, meta=meta)
                self.last_write_s = now() - t0
            except BaseException as e:
                with self._lock:
                    self._error = e
                logger.warning("background checkpoint write of %s failed: "
                               "%s: %s", path, type(e).__name__, e)
                flight_recorder.record(
                    "checkpoint_write_failed", path=path,
                    error=f"{type(e).__name__}: {e}")
                log_event("checkpoint_write_failed", path=path,
                          error=f"{type(e).__name__}: {e}")
            finally:
                self._idle.set()

    def busy(self) -> bool:
        """Whether a save is queued or being written."""
        return not self._idle.is_set()

    def drain(self, raise_on_error: bool = True) -> None:
        """Block until the in-flight save committed (or failed).  A
        failed write raises `CheckpointWriteError` here, once, unless
        `raise_on_error=False` (read paths that only need quiescence);
        then it stays for a later raising drain."""
        self._idle.wait()
        with self._lock:
            err = self._error
            if raise_on_error:
                self._error = None
        if err is not None and raise_on_error:
            raise CheckpointWriteError(
                f"background checkpoint write failed: "
                f"{type(err).__name__}: {err}") from err

    def close(self) -> None:
        self.drain(raise_on_error=False)
        self._stop = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


_global_lock = threading.Lock()
_global: Optional[BackgroundCheckpointer] = None


def get_background_checkpointer() -> BackgroundCheckpointer:
    global _global
    with _global_lock:
        if _global is None:
            _global = BackgroundCheckpointer()
            atexit.register(_global.close)
        return _global


def drain_background(raise_on_error: bool = True) -> None:
    """Drain the process-global writer if one exists (a no-op, and no
    writer thread made, otherwise)."""
    with _global_lock:
        writer = _global
    if writer is not None:
        writer.drain(raise_on_error=raise_on_error)
