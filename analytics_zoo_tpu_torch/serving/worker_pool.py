"""Multi-replica serving scale-out: the Flink-parallelism analog (a port
of analytics_zoo_tpu/serving/worker_pool.py; reference: Cluster
Serving's `modelParallelism`, `ClusterServing.scala:57-70`).

N worker processes each load their own copy of a saved model
(`ZooModel.save_model`'s format) and serve batches over a
length-prefixed pickle pipe; the parent's dynamic batcher checks workers
out of a queue, so up to N batches predict at once, each in its own
interpreter (no shared GIL), and a slow worker delays only its batch.

Each worker is a fresh interpreter started with `subprocess.Popen`
(never a fork of a parent that may have touched CUDA).  Workers run on
the CUDA card unless the pool is built with ``device="cpu"``: an H100
holds one CUDA context per worker process beside the parent's.  With
``device="cpu"`` a worker sees ``CUDA_VISIBLE_DEVICES=""``; a worker
asked for the card that finds none fails to load, and the pool raises.
`worker_env` overrides the child's environment; its `PYTHONPATH`
starts with this checkout.

Besides ``predict`` frames the pipe carries ``launch_counts`` /
``reset_launch_counts`` frames: the kernel wrappers' launch counts of
each worker process, read by `WorkerPool.launch_counts()` (nothing a
client of the server sees).
"""

from __future__ import annotations

import os
import pickle
import struct
import subprocess
import sys
import threading
import queue as _queue
from typing import Any, Dict, List, Optional, Tuple

from analytics_zoo_tpu_torch.observability import (
    get_registry,
    log_event,
    trace,
)
from analytics_zoo_tpu_torch.serving.control_plane.admission import (
    AdmissionCore,
)
from analytics_zoo_tpu_torch.serving.errors import (
    ReplicaDiedMidPredict,
    ReplicaStopped,
)

_FRAME = struct.Struct(">I")


def _send(stream, obj) -> None:
    blob = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    stream.write(_FRAME.pack(len(blob)) + blob)
    stream.flush()


def _recv(stream):
    head = stream.read(_FRAME.size)
    if len(head) < _FRAME.size:
        raise EOFError("worker closed the pipe")
    (n,) = _FRAME.unpack(head)
    blob = stream.read(n)
    if len(blob) < n:
        raise EOFError("worker closed mid-frame")
    return pickle.loads(blob)


def _worker_env(extra: Optional[Dict[str, str]],
                device: Optional[str]) -> Dict[str, str]:
    """The child's environment: the parent's, this checkout first on
    `PYTHONPATH`, no card visible for ``device="cpu"``, then `extra`."""
    env = dict(os.environ)
    # keep the checkout importable whatever cwd the parent runs from
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = (root + os.pathsep + env.get("PYTHONPATH", ""))
    if device is not None and str(device) == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""
    if extra:
        env.update(extra)
    return env


class _Worker:
    """Spawns + sends the load config immediately (non-blocking), so a
    pool of N replicas loads in parallel; call `wait_ready()` before
    first use."""

    def __init__(self, model_path: str, model_cls: Optional[str],
                 quantize: bool, decrypt_key_env: Optional[str],
                 env: Optional[Dict[str, str]],
                 max_batch_size: int = 256,
                 model_parallelism: int = 1,
                 device: Optional[str] = None):
        code = ("from analytics_zoo_tpu_torch.serving.worker_pool import "
                "worker_main\nworker_main()\n")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", code],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            env=_worker_env(env, device))
        self.lock = threading.Lock()
        self.served = 0   # records served by THIS replica
        _send(self.proc.stdin, {
            "model_path": model_path, "model_cls": model_cls,
            "quantize": quantize, "decrypt_key_env": decrypt_key_env,
            "max_batch_size": max_batch_size,
            "model_parallelism": model_parallelism, "device": device})

    def wait_ready(self) -> None:
        ack = _recv(self.proc.stdout)
        if ack.get("status") != "ready":
            raise RuntimeError(f"serving worker failed to load model: "
                               f"{ack.get('error')}")

    def call(self, kind: str, payload=None):
        """One request frame and its answer."""
        with self.lock:
            _send(self.proc.stdin, (kind, payload))
            status, answer = _recv(self.proc.stdout)
        if status == "err":
            raise RuntimeError(answer)
        return answer

    def predict(self, inputs: Tuple) -> Tuple:
        return self.call("predict", inputs)

    def stop(self):
        # take the frame lock (bounded) so an in-flight predict's write
        # cannot interleave with the exit frame (frames exceed
        # PIPE_BUF); a replica wedged mid-predict keeps the lock, in
        # which case the polite exit is skipped and the process killed
        # directly (no point waiting for an exit frame never sent)
        sent_exit = False
        if self.lock.acquire(timeout=5):
            try:
                _send(self.proc.stdin, ("exit", None))
                sent_exit = True
            except Exception:
                pass
            finally:
                self.lock.release()
        try:
            if sent_exit:
                self.proc.wait(timeout=5)
            else:
                raise TimeoutError
        except Exception:
            self.proc.kill()
            self.proc.wait()   # reap — no zombie for the parent's life


class WorkerPool:
    """N model replicas behind a checkout queue; `predict` is
    thread-safe and blocks until a replica is free.  `device` is each
    worker's torch device (None = the CUDA card)."""

    def __init__(self, model_path: str, n_workers: int = 2,
                 model_cls: Optional[str] = None,
                 quantize: bool = False,
                 decrypt_key_env: Optional[str] = None,
                 worker_env: Optional[Dict[str, str]] = None,
                 max_batch_size: int = 256,
                 model_parallelism: int = 1,
                 max_queue: Optional[int] = None,
                 device: Optional[str] = None):
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        self.n_workers = n_workers
        self.device = device
        self._stopping = False
        self._spawn_args = (model_path, model_cls, quantize,
                            decrypt_key_env, worker_env,
                            max_batch_size, model_parallelism, device)
        self._workers = []
        try:
            # spawn all first (configs already sent), then collect the
            # ready acks: N replicas load in parallel, and a failed load
            # tears down the ones already spawned instead of leaking
            # orphan processes
            self._workers = [_Worker(*self._spawn_args)
                             for _ in range(n_workers)]
            for w in self._workers:
                w.wait_ready()
        except Exception:
            for w in self._workers:
                w.stop()
            raise
        self._free: "_queue.Queue[_Worker]" = _queue.Queue()
        for w in self._workers:
            self._free.put(w)
        self._served = 0
        self._served_lock = threading.Lock()
        # checkout-wait histogram + respawn counter live in the
        # process-global registry (a pool may outlive/predate servers);
        # busy count drives the /stats + /metrics utilization gauge
        self._busy = 0
        reg = get_registry()
        self._h_checkout = reg.histogram(
            "serving_worker_checkout_wait_seconds",
            help="time a batch waited to check a replica out")
        self._c_respawns = reg.counter(
            "serving_worker_respawns_total",
            help="replica processes respawned after dying mid-predict")
        # the pool's door is the AdmissionCore that fronts the
        # generation engine: `max_queue` bounds the batches blocked on
        # checkout (None = unbounded) and tenant quotas charge here too;
        # the pool has no shed logic of its own
        self._waiting = 0
        self.admission = AdmissionCore(max_queue=max_queue,
                                       retry_after=self._retry_after)

    def _retry_after(self) -> float:
        """Shed-response backoff hint: the measured mean checkout wait
        (0.5s before any batch has waited), clamped to [0.05s, 10s]."""
        h = self._h_checkout
        if h.calls:
            return float(min(10.0, max(0.05, h.total / h.calls)))
        return 0.5

    @property
    def records_served(self) -> int:
        return self._served

    @property
    def busy_workers(self) -> int:
        """Replicas currently running a predict."""
        with self._served_lock:
            return self._busy

    def utilization(self) -> float:
        """busy / n_workers in [0, 1]."""
        return self.busy_workers / max(self.n_workers, 1)

    def predict(self, *inputs, tenant: Optional[str] = None,
                request_class: str = "interactive") -> Any:
        import numpy as np
        arrays = tuple(np.asarray(a) for a in inputs)
        # one admission decision (queue bound + fault site + tenant
        # quota) BEFORE blocking on checkout: a shed request never
        # occupies a waiter slot.  Raises QueueFull (503) /
        # TenantQuotaExceeded (429); the HTTP layer maps both.
        with self._served_lock:
            depth = self._waiting
        self.admission.admit(depth, tenant=tenant,
                             request_class=request_class)
        with self._served_lock:
            self._waiting += 1
        try:
            with self._h_checkout.time():
                w = self._free.get()
        finally:
            with self._served_lock:
                self._waiting -= 1
        with self._served_lock:
            self._busy += 1
        try:
            try:
                with trace("serving.worker_predict",
                           records=len(arrays[0])):
                    outs = w.predict(arrays)
                w.served += len(arrays[0])
            except (EOFError, BrokenPipeError, OSError) as e:
                # the replica process died: REPLACE it so the pool
                # heals instead of handing the corpse to 1/N of future
                # batches.  Only a live worker goes back in the
                # checkout queue; if the pool is shutting down (or the
                # respawn fails) it shrinks by one instead of leaking a
                # fresh orphan process.
                w.stop()
                if self._stopping:
                    raise ReplicaStopped(
                        f"serving replica stopped ({e})") from e
                self._c_respawns.inc()
                log_event("worker_respawn",
                          error=f"{type(e).__name__}: {e}")
                try:
                    repl = _Worker(*self._spawn_args)
                    repl.wait_ready()
                    self._workers[self._workers.index(w)] = repl
                    self._free.put(repl)
                except Exception:
                    self._workers.remove(w)
                raise ReplicaDiedMidPredict(
                    f"serving replica died mid-predict ({e}); "
                    "replaced") from e
            except Exception:
                self._free.put(w)  # inference error; the replica is fine
                raise
            self._free.put(w)
            with self._served_lock:
                self._served += len(arrays[0])
            return outs if len(outs) > 1 else outs[0]
        finally:
            with self._served_lock:
                self._busy -= 1

    def per_worker_served(self):
        """Records served by each replica (dispatch distribution)."""
        return [w.served for w in self._workers]

    def pids(self) -> List[int]:
        """The worker processes' pids, in worker order."""
        return [w.proc.pid for w in self._workers]

    def launch_counts(self) -> List[Dict[str, Any]]:
        """Each worker's kernel launch counts since its last reset:
        {"counts": {kernel: launches}, "by_body": {kernel: {body: n}},
        "pid", "device", "allocated_bytes"}.  Asks every worker in turn
        (each answers between two predicts)."""
        return [w.call("launch_counts") for w in list(self._workers)]

    def reset_launch_counts(self) -> None:
        """Set every worker's kernel launch counts to 0."""
        for w in list(self._workers):
            w.call("reset_launch_counts")

    def consume_stream(self, stream, out_stream=None, **kw):
        """Attach this pool to a durable stream as a consumer-group
        member: each leased record's inputs run through `predict`, the
        result is appended to `out_stream`, and only then is the
        record acked — a pool (or its host) dying mid-record leaves
        the lease to expire and the record replays to a surviving
        consumer under the same record id (docs/streaming.md).
        Returns the started `StreamConsumer` (stop() to detach)."""
        from analytics_zoo_tpu_torch.serving.streaming.consumer import (
            predict_consumer,
        )
        return predict_consumer(stream, self.predict,
                                out_stream=out_stream, **kw)

    def stop(self):
        self._stopping = True
        for w in list(self._workers):
            w.stop()


def _launch_counts(device) -> Dict[str, Any]:
    """The kernel wrappers' counts in this process, and where it runs
    (with the bytes its tensors hold on the card)."""
    import torch

    from analytics_zoo_tpu_torch.ops import kernels
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
    return {"counts": kernels.launch_counts(),
            "by_body": {name: dict(getattr(fn, "launches_by_body", {}))
                        for name, fn in kernels.KERNELS.items()},
            "pid": os.getpid(), "device": str(device),
            "allocated_bytes": (torch.cuda.memory_allocated(device)
                                if on_card else 0)}


def worker_main():  # pragma: no cover - runs in the child process
    """Child loop: load the model, then serve length-prefixed pickle
    frames on stdin/stdout until an exit frame."""
    stdin = sys.stdin.buffer
    stdout = sys.stdout.buffer
    # anything the model prints must not corrupt the frame stream
    sys.stdout = sys.stderr
    cfg = _recv(stdin)
    try:
        import torch

        from analytics_zoo_tpu_torch.serving.inference_model import (
            InferenceModel,
            find_zoo_model_class,
        )
        decrypt_key = None
        if cfg.get("decrypt_key_env"):
            decrypt_key = os.environ.get(cfg["decrypt_key_env"])
        cls = (find_zoo_model_class(cfg["model_cls"])
               if cfg.get("model_cls") else None)
        model = InferenceModel(
            supported_concurrent_num=cfg.get("model_parallelism", 1),
            max_batch_size=cfg.get("max_batch_size", 256))
        model.load_model(cfg["model_path"], model_cls=cls,
                         quantize=cfg.get("quantize", False),
                         decrypt_key=decrypt_key, device=cfg.get("device"))
        if model._device.type == "cuda":
            # the TF32 setting of the serving process the worker stands in
            # for: a CUDA worker's f32 products are full f32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _send(stdout, {"status": "ready", "pid": os.getpid(),
                       "device": str(model._device)})
    except Exception as e:
        _send(stdout, {"status": "error",
                       "error": f"{type(e).__name__}: {e}"})
        return
    while True:
        try:
            kind, payload = _recv(stdin)
        except EOFError:
            return
        if kind == "exit":
            return
        try:
            if kind == "predict":
                outs = model.predict(*payload)
                if not isinstance(outs, tuple):
                    outs = (outs,)
            elif kind == "launch_counts":
                outs = _launch_counts(model._device)
            elif kind == "reset_launch_counts":
                from analytics_zoo_tpu_torch.ops import kernels
                kernels.reset_launch_counts()
                outs = None
            else:
                raise ValueError(f"unknown frame kind {kind!r}")
            _send(stdout, ("ok", outs))
        except Exception as e:
            _send(stdout, ("err", f"{type(e).__name__}: {e}"))
