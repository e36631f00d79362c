"""Orca Estimator — fit/evaluate/predict over a torch module on one card
(counterpart of analytics_zoo_tpu/orca/learn/estimator.py).

`Estimator.from_torch(module, ...)` is the port's counterpart of the JAX
`from_flax` (estimator.py:109): the port's models are torch modules, so
they train as they are (the JAX `from_torch`, which imports a torch
module into flax, has no role here).  The module trains on the device
its parameters are on; the port's models are built on the card unless
given another device.  Loss and metrics default to the module's
`default_loss` / `default_metrics` where it names them.  With
`aux_loss_weight` the module returns `(predictions, aux)` and the train
loss adds weight * aux (the engine's `_split_aux`; `aux_loss` in
`train_summary` and in `evaluate`), as JAX's `from_flax` takes it
(estimator.py:112-121).  `set_params` replaces the module's parameters
(a state_dict, or a callable of the current one) and
`get_model_state` returns its buffers, as JAX's (estimator.py:611-660);
of `load` and `set_params` the last call wins.

`Estimator.from_onnx(path_or_bytes)` trains an imported ONNX graph
(`pipeline/onnx/`), as JAX's `from_onnx` (estimator.py:159-170).

`Estimator.from_keras(model)` trains a Keras-style model
(`analytics_zoo_tpu_torch.keras`) as JAX's does (estimator.py:124-136):
a compiled model's loss, optimizer and metrics unless overridden.  Its
graph module has no parameters until it has seen data (flax infers the
widths at `init`), so the engine waits for the first batch of
whichever of `fit`, `evaluate` or `predict` comes first, builds the
module on that batch's first row with the Estimator's `seed`
(`GraphModule.build`), and only then exists; `load` and `set_params`
calls made before are queued and replayed in call order, as JAX's
`_deferred_ops` (estimator.py:176-199).

Data: {"x": ndarray(s), "y": ndarray(s)} or (x, y) tuples of numpy
arrays, pandas DataFrames with `feature_cols` / `label_cols`, XShards of
any of those (streamed shard by shard, never concatenated), or a
zero-argument callable returning one, batched and padded by
`HostDataset`; host batches reach the card through the engine's pinned
double buffering (`OrcaContext.host_input_prefetch`).  With
`OrcaContext.train_data_store == "DEVICE"`, `fit` uploads the padded
dataset to the card once and trains from it there (estimator.py:252);
the upload is cached across `fit` calls on the same arrays.  Streaming
(XShards) input is never uploaded: it streams from the host, with a
warning, as in JAX (estimator.py:475-479).

With `model_dir`, `fit` writes checkpoints through the commit protocol
(`checkpoint.py`) when its trigger fires (`EveryEpoch` by default;
step-granular triggers fire mid-epoch, under the loop-local step), and
on a failure restores the newest committed checkpoint and re-runs from
the epoch cursor in its sidecar, up to `max_failures` times
(`OrcaContext.failure_retry_times`), as the JAX `fit` does
(estimator.py:211-433).  `NaNLossError` and `KeyboardInterrupt` are
never retried, and without `model_dir` a failure is raised.
`validation_data` is evaluated after each epoch into `val_summary`;
`set_tensorboard` writes both summaries as TensorBoard event files.
`profile=True` keeps each step's host wall time in `profile_stats`, and
`profiler_dir` captures a `torch.profiler` trace of the fit there
(where JAX uses `jax.profiler`).  The watchdog, the flight recorder,
the goodput clocks and the trace spans are not ported.
"""

from __future__ import annotations

import json
import logging
import os
import time
import zlib
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.orca.learn import checkpoint as ckpt_mod
from analytics_zoo_tpu_torch.orca.learn import losses as losses_mod
from analytics_zoo_tpu_torch.orca.learn import metrics as metrics_mod
from analytics_zoo_tpu_torch.orca.learn import optimizers as optim_mod
from analytics_zoo_tpu_torch.orca.learn.spmd import DeviceDataset, TrainEngine
from analytics_zoo_tpu_torch.orca.learn.trigger import EveryEpoch, Trigger
from analytics_zoo_tpu_torch.orca.learn.utils import HostDataset
from analytics_zoo_tpu_torch.resilience.checkpointing import drain_background
from analytics_zoo_tpu_torch.resilience.retry import RetryPolicy

logger = logging.getLogger("analytics_zoo_tpu_torch")


class NaNLossError(RuntimeError):
    """Raised under nan_policy='raise' when a training epoch hit
    non-finite loss/gradients (the skipped steps are reported)."""


class Estimator:
    """sklearn-style fit/evaluate/predict over one `TrainEngine`."""

    def __init__(self, module, *, loss=None, optimizer=None, metrics=None,
                 learning_rate=None, clip_norm=None, clip_value=None,
                 model_dir: Optional[str] = None, seed: int = 0,
                 aux_loss_weight: Optional[float] = None):
        if loss is None:
            loss = getattr(module, "default_loss", None)
        if metrics is None:
            metrics = list(getattr(module, "default_metrics", ()))
        self._seed = seed
        self.model_dir = model_dir
        self._module = module
        self._engine_args = dict(
            optimizer=optim_mod.resolve(optimizer, learning_rate, clip_norm,
                                        clip_value),
            loss_fn=losses_mod.resolve(loss),
            metric_fns=metrics_mod.resolve_all(metrics), seed=seed,
            aux_loss_weight=aux_loss_weight)
        self._engine: Optional[TrainEngine] = None
        #: load() / set_params() calls made before the engine exists,
        #: replayed in call order when it is built
        self._deferred_ops: list = []
        if getattr(module, "built", True):
            self._build_engine()
        self._epoch = 0
        self.train_summary: List[Dict[str, Any]] = []
        self.val_summary: List[Dict[str, Any]] = []
        #: failure retries taken, across fit calls
        self.retries = 0
        self._tb_writers = None
        #: per-step host wall times from fit(..., profile=True)
        self.profile_stats: List[Dict[str, Any]] = []
        #: the DEVICE store's uploads: key -> (DeviceDataset, source arrays)
        self._device_cache: Dict[Any, Any] = {}
        self.device_cache_hits = 0

    @classmethod
    def from_torch(cls, module, **kwargs) -> "Estimator":
        """Keywords: `loss`, `metrics`; `optimizer`, a name ("adam",
        "adamw", "sgd", "rmsprop", "adagrad", "adadelta"), an
        `optimizers.Optimizer` (with or without a learning-rate
        schedule), or None (adam); `learning_rate` its
        rate; `clip_norm` / `clip_value` the gradient clipping;
        `model_dir` where checkpoints go; `seed` the shuffling and the
        dropout generator; `aux_loss_weight` the weight of the aux term
        of a module returning (predictions, aux).  `loss` also takes a
        torch criterion (`nn.CrossEntropyLoss()` and the others
        `torch_adapter.resolve_torch_loss` maps), as JAX's `from_torch`
        does (estimator.py:146-150)."""
        from analytics_zoo_tpu_torch.orca.learn.torch_adapter import (
            resolve_torch_loss,
        )
        if "loss" in kwargs:
            kwargs["loss"] = resolve_torch_loss(kwargs["loss"])
        return cls(module, **kwargs)

    @classmethod
    def from_keras(cls, model, *, loss=None, optimizer=None, metrics=None,
                   model_dir=None, shard_rules=None, **kwargs
                   ) -> "Estimator":
        """Train a `keras.Model` / `Sequential`: its `compile()`d loss,
        optimizer and metrics unless given here; the other keywords are
        `from_torch`'s.  The model's graph module is built on the first
        batch (module docstring).  `shard_rules` (JAX's mesh sharding)
        has no mesh to act on with one card: only None is taken."""
        if shard_rules is not None:
            raise ValueError("shard_rules needs a device mesh; the port "
                             "trains on one card")
        loss = loss if loss is not None else getattr(model, "_loss", None)
        optimizer = (optimizer if optimizer is not None
                     else getattr(model, "_optimizer", None))
        metrics = (metrics if metrics is not None
                   else getattr(model, "_metrics", None))
        return cls(model.to_torch(), loss=loss, optimizer=optimizer,
                   metrics=metrics, model_dir=model_dir, **kwargs)

    @classmethod
    def from_onnx(cls, path_or_bytes, *, loss=None, optimizer=None,
                  metrics=None, model_dir=None, device=None,
                  **kwargs) -> "Estimator":
        """Train an imported .onnx model (path or bytes), as JAX's
        `from_onnx` does (estimator.py:159-170): the graph becomes an
        `OnnxModule` on `device` (None = the CUDA card) whose weight
        initializers are trainable parameters, then `from_torch`.  The
        module reads shape-like inputs from graph constants only
        (`static_shapes`), as JAX's jitted step does."""
        from analytics_zoo_tpu_torch.pipeline.onnx import load_onnx
        module, _ = load_onnx(path_or_bytes, device=device,
                              static_shapes=True)
        return cls.from_torch(module, loss=loss, optimizer=optimizer,
                              metrics=metrics, model_dir=model_dir,
                              **kwargs)

    def _build_engine(self) -> None:
        self._engine = TrainEngine(self._module, **self._engine_args)
        ops, self._deferred_ops = self._deferred_ops, []
        for kind, value in ops:
            if kind == "load":
                self.load(value)
            else:
                self.set_params(value)

    def _ensure_engine(self, ds: HostDataset, batch_size: int) -> None:
        """Build a graph module waiting for data on the first row of
        `ds`'s first batch, then the engine."""
        if self._engine is not None:
            return
        feats = ds.probe(batch_size)["features"]
        self._module.build(*(a[:1] for a in feats), seed=self._seed)
        self._build_engine()

    @property
    def engine(self) -> Optional[TrainEngine]:
        """The training engine (None until a Keras model has seen its
        first batch)."""
        return self._engine

    def _device_type(self) -> str:
        if self._engine is not None:
            return self._engine.device.type
        return self._module.device.type

    def fit(self, data, epochs: int = 1, batch_size: int = 32,
            feature_cols: Optional[Sequence[str]] = None,
            label_cols: Optional[Sequence[str]] = None,
            validation_data=None, checkpoint_trigger: Optional[Trigger] = None,
            shuffle: bool = True, nan_policy: str = "warn",
            max_failures: Optional[int] = None, profile: bool = False,
            profiler_dir: Optional[str] = None) -> "Estimator":
        """Train for `epochs`, from host batches or, where
        `OrcaContext.train_data_store` is "DEVICE", from the dataset
        uploaded to the card.  Steps with non-finite loss or gradients
        are skipped on the device; `nan_policy` "warn" logs them, "raise"
        aborts with NaNLossError.  The last epoch's per-step stats are in
        `engine.last_steps`.  `feature_cols` / `label_cols` name the
        columns of DataFrame input (and of `validation_data`).

        On a training failure the newest committed checkpoint under
        `model_dir` is restored and training resumes from its epoch, up
        to `max_failures` times (default
        `OrcaContext.failure_retry_times`)."""
        if nan_policy not in ("warn", "raise"):
            raise ValueError("nan_policy must be 'warn' or 'raise'")
        if profiler_dir is not None:
            return self._fit_profiled(
                profiler_dir, data, epochs=epochs, batch_size=batch_size,
                feature_cols=feature_cols, label_cols=label_cols,
                validation_data=validation_data,
                checkpoint_trigger=checkpoint_trigger, shuffle=shuffle,
                nan_policy=nan_policy, max_failures=max_failures,
                profile=profile)
        ds = HostDataset.from_data(data, feature_cols, label_cols)
        if not ds.has_labels:
            raise ValueError("fit requires labels: pass {'x': ..., 'y': ...}, "
                             "an (x, y) tuple, or label_cols for DataFrame "
                             "input")
        val_ds = (HostDataset.from_data(validation_data, feature_cols,
                                        label_cols)
                  if validation_data is not None else None)
        if self._engine_args["loss_fn"] is None:
            raise ValueError("fit needs a loss")
        self._ensure_engine(ds, batch_size)
        dds = (self._device_dataset(ds, batch_size, shuffle)
               if OrcaContext.train_data_store == "DEVICE" else None)
        trigger = Trigger.resolve(checkpoint_trigger)
        if trigger is None and self.model_dir:
            trigger = EveryEpoch()
        start_epoch = self._epoch
        target_epoch = self._epoch + epochs
        budget = (OrcaContext.failure_retry_times
                  if max_failures is None else max_failures)
        retry_policy = RetryPolicy(
            max_attempts=budget + 1,
            backoff_s=OrcaContext.failure_retry_interval_s,
            name="estimator_fit")
        failures = 0
        pending_restore = False
        try:
            while self._epoch < target_epoch:
                try:
                    if pending_restore:
                        # inside the try: a still-broken checkpoint or
                        # data source consumes retry budget
                        self._restore_latest(start_epoch, target_epoch)
                        pending_restore = False
                    self._fit_one_epoch(ds, val_ds, batch_size, trigger,
                                        shuffle, nan_policy, profile, dds)
                except (NaNLossError, KeyboardInterrupt):
                    raise
                except Exception as e:
                    failures += 1
                    if failures > budget or not self.model_dir:
                        raise
                    self.retries += 1
                    retry_policy.record_retry(e)
                    logger.warning(
                        "training failed (%s: %s); restoring the latest "
                        "checkpoint and retrying (%d retries left)",
                        type(e).__name__, e, budget - failures)
                    time.sleep(retry_policy.backoff(failures))
                    pending_restore = True
        finally:
            # after fit returns (or raises) every triggered save is
            # durable; a failed write was logged by the writer
            drain_background(raise_on_error=False)
        return self

    def _fit_profiled(self, profiler_dir: str, data, **kwargs):
        """`fit` under a `torch.profiler` trace of the host and, on the
        card, the device, written to `profiler_dir` as a Chrome trace
        (`fit-<pid>-<n>.pt.trace.json`, viewable in Perfetto)."""
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self._device_type() == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(profiler_dir, exist_ok=True)
        with profile(activities=activities) as prof:
            self.fit(data, **kwargs)
        n = len([f for f in os.listdir(profiler_dir) if f.endswith(".json")])
        prof.export_chrome_trace(os.path.join(
            profiler_dir, f"fit-{os.getpid()}-{n}.pt.trace.json"))
        return self

    def _fit_one_epoch(self, ds, val_ds, batch_size, trigger, shuffle,
                       nan_policy, profile=False, dds=None):
        eng = self._engine

        def on_step(step):
            # step-granular triggers fire mid-epoch, under the loop-local
            # step: host_step commits only at the epoch's end
            if trigger and self.model_dir and trigger(
                    epoch=self._epoch, step=step, epoch_end=False):
                self.save_checkpoint(step=step)

        t0 = time.perf_counter()
        if dds is not None:
            stats = eng.run_epoch_device(dds, train=True, shuffle=shuffle,
                                         seed=self._seed, epoch=self._epoch,
                                         on_step=on_step, profile=profile)
        else:
            stats = eng.run_epoch(
                ds.batches(batch_size, shuffle=shuffle, seed=self._seed,
                           epoch=self._epoch),
                train=True, on_step=on_step, profile=profile)
        if profile:
            self.profile_stats.extend(eng.last_profile)
        self._epoch += 1
        if trigger is not None and hasattr(trigger, "last_loss"):
            trigger.last_loss = stats.get("loss")
        step = eng.host_step
        wall = time.perf_counter() - t0
        stats.update(epoch=self._epoch, step=step, wall_s=wall,
                     samples_per_s=ds.n / max(wall, 1e-9))
        self.train_summary.append(stats)
        self._tb_log("train", stats, step)
        if val_ds is not None:
            vstats = eng.run_epoch(val_ds.batches(batch_size), train=False)
            vstats.update(epoch=self._epoch, step=step)
            self.val_summary.append(vstats)
            self._tb_log("validation", vstats, step)
        nan_msg = None
        if stats.get("nan_steps"):
            nan_msg = (f"{int(stats['nan_steps'])} training step(s) in epoch "
                       f"{self._epoch} had non-finite loss/gradients and "
                       "were skipped")
        if nan_msg and nan_policy == "raise":
            # a NaN epoch is a failed one: no checkpoint is written for it
            raise NaNLossError(nan_msg)
        if trigger and self.model_dir and trigger(
                epoch=self._epoch, step=step, epoch_end=True):
            self.save_checkpoint()
        if nan_msg:
            logger.warning(nan_msg)

    def _restore_latest(self, start_epoch, target_epoch):
        """Rewind to the newest committed checkpoint under model_dir, or
        keep the state in memory if none was written yet (resyncing the
        step mirror a failed epoch left behind).  The epoch cursor comes
        from the checkpoint's sidecar; as in JAX, a mid-epoch checkpoint
        re-runs its whole epoch from that state."""
        try:
            path = ckpt_mod.find_latest_checkpoint(self.model_dir)
        except (FileNotFoundError, OSError):
            self._engine.sync_host_step()
            return
        self.load(path)
        epoch = start_epoch
        try:
            with open(path + ".meta.json") as f:
                epoch = int(json.load(f)["epoch"])
        except (FileNotFoundError, OSError, KeyError, ValueError):
            pass  # no sidecar: re-run from this fit's start
        self._epoch = min(max(epoch, start_epoch), target_epoch - 1)

    @staticmethod
    def _content_fingerprint(arrays) -> tuple:
        """A sampled content hash (estimator.py:435): crc32 of the first
        4 KB of up to 8 rows spread over each array's leading axis.  It
        sees an in-place change to any sampled row; a change confined to
        unsampled rows goes unseen (do not mutate sources between
        fits)."""
        parts = []
        for a in arrays:
            a = np.asarray(a)
            if a.ndim == 0:
                parts.append(zlib.crc32(a.tobytes()))
                continue
            n = a.shape[0]
            crc = 0
            for i in sorted({0, n - 1, *((n * k) // 7 for k in range(1, 7))}):
                blk = np.ascontiguousarray(a[i:i + 1])
                crc = zlib.crc32(blk.tobytes()[:4096], crc)
            parts.append(crc)
        return tuple(parts)

    def _device_dataset(self, ds: HostDataset, batch_size: int,
                        shuffle: bool = False) -> Optional[DeviceDataset]:
        """The DEVICE store's upload of `ds` (estimator.py:462-524), or
        None (host streaming, with a warning) when its padded footprint,
        counted twice for a shuffled fit (the permutation makes a second
        copy), passes `OrcaContext.device_cache_bytes`.  Cached on the
        source arrays' ids, shapes and dtypes, the batch size and a
        sampled content fingerprint; the sources are held beside the
        upload, so an id stays theirs while the entry lives.  Streaming
        (XShards) input is never uploaded: its `features` are the head
        shard's alone."""
        if type(ds) is not HostDataset:
            logger.warning(
                "train_data_store='DEVICE' ignored for streaming input; "
                "using host streaming")
            return None
        arrays = tuple(ds.features) + tuple(ds.labels)
        steps, b = self._engine.cached_layout(ds.n, batch_size)
        row_bytes = sum(a.dtype.itemsize * int(np.prod(a.shape[1:],
                                                       dtype=np.int64))
                        for a in arrays) + 4      # + the f32 mask
        # checked before the cache lookup: a dataset cached by an
        # unshuffled fit is held to twice its size by a shuffled one
        nbytes = steps * b * row_bytes * (2 if shuffle else 1)
        cap = OrcaContext.device_cache_bytes
        if nbytes > cap:
            logger.warning(
                "dataset needs %d device bytes (padded%s), over "
                "device_cache_bytes (%d); using host streaming", nbytes,
                ", x2 for shuffle" if shuffle else "", cap)
            return None
        key = (tuple((id(a), a.shape, str(a.dtype)) for a in arrays),
               int(batch_size), len(ds.features),
               self._content_fingerprint(arrays))
        hit = self._device_cache.get(key)
        if hit is not None:
            self.device_cache_hits += 1
            return hit[0]
        # a mutated source has a new fingerprint: its old upload is stale
        for stale in [k for k in self._device_cache
                      if k[:3] == key[:3] and k != key]:
            del self._device_cache[stale]
        held = sum(entry[0].nbytes for entry in self._device_cache.values())
        if held + nbytes > cap:
            self._device_cache.clear()
        dds = self._engine.cache_dataset(ds.features, ds.labels, batch_size)
        self._device_cache[key] = (dds, arrays)
        return dds

    def evaluate(self, data, batch_size: int = 32, feature_cols=None,
                 label_cols=None) -> Dict[str, float]:
        ds = HostDataset.from_data(data, feature_cols, label_cols)
        if not ds.has_labels:
            raise ValueError(
                "evaluate requires labels: pass {'x': ..., 'y': ...}, an "
                "(x, y) tuple, or label_cols for DataFrame input")
        self._ensure_engine(ds, batch_size)
        return self._engine.run_epoch(ds.batches(batch_size), train=False)

    def predict(self, data, batch_size: int = 32, feature_cols=None):
        """Stacked predictions (numpy, or a tuple of them), padding rows
        dropped, in the input's row order (XShards and DataFrames
        included)."""
        ds = HostDataset.from_data(data, feature_cols, None)
        self._ensure_engine(ds, batch_size)
        outs = self._engine.predict_all(ds.batches(batch_size))
        if not outs:
            return None
        if isinstance(outs[0], (tuple, list)):
            return type(outs[0])(np.concatenate([o[i] for o in outs])
                                 for i in range(len(outs[0])))
        return np.concatenate(outs)

    def get_model(self):
        """The trained torch module (its parameters are the engine's)."""
        return self._module

    def get_model_state(self) -> Dict[str, Any]:
        """The module's buffers (BatchNorm's running statistics and
        counts), as host tensors: JAX's mutable model collections."""
        params = {n for n, _ in self._module.named_parameters()}
        return {k: v.detach().cpu().clone()
                for k, v in self._module.state_dict().items()
                if k not in params}

    def set_params(self, params) -> "Estimator":
        """Replace the module's parameters on its device.  `params` is a
        state_dict (every parameter by name; buffers it names are loaded
        too), or a callable mapping the current state_dict to one, e.g.
        a pretrained-weight loader::

            est.set_params(lambda p: load_bert_pretrained(p, ckpt_path))

        The optimizer state is kept, as JAX's engine keeps it.  Before
        a Keras model's first batch the call is queued."""
        if self._engine is None:
            self._deferred_ops.append(("set_params", params))
            return self
        model = self._engine.model
        if callable(params):
            params = params(model.state_dict())
        missing = sorted({n for n, _ in model.named_parameters()}
                         - set(params))
        unknown = sorted(set(params) - set(model.state_dict()))
        if missing or unknown:
            raise ValueError(f"set_params: missing parameters {missing}, "
                             f"unknown entries {unknown}")
        # copied into the parameters in place: the optimizer holds them
        model.load_state_dict(params, strict=False)
        return self

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------

    def save(self, path: str) -> str:
        """Write the engine's state to `path` through the commit
        protocol (synchronous on the CPU, background on the card)."""
        self._require_engine("save")
        ckpt_mod.save_checkpoint(path, self._engine.state_dict())
        return path

    def load(self, path: str) -> "Estimator":
        """Restore the state saved at `path`: parameters, optimizer and
        schedule state, the dropout generator and the step count.
        Before a Keras model's first batch the call is queued."""
        if self._engine is None:
            self._deferred_ops.append(("load", path))
            return self
        self._engine.load_state_dict(ckpt_mod.load_checkpoint(path))
        return self

    def save_checkpoint(self, step: Optional[int] = None) -> str:
        """Write `model_dir/ckpt-<step>` with its epoch/step sidecar and
        commit marker.  With `OrcaContext.background_checkpointing` the
        save leaves the critical path after one snapshot to host
        tensors; otherwise `checkpoint.async_save_enabled` decides.
        Mid-epoch callers must pass the loop-local `step`: `host_step`
        commits only at an epoch's end."""
        self._require_engine("save_checkpoint")
        if step is None:
            step = self._engine.host_step
        path = os.path.join(self.model_dir, f"ckpt-{step}")
        block = False if OrcaContext.background_checkpointing else None
        return ckpt_mod.save_checkpoint(
            path, self._engine.state_dict(), block=block,
            meta={"epoch": self._epoch, "step": step})

    def _require_engine(self, what: str) -> None:
        if self._engine is None:
            raise RuntimeError(f"{what}: the Keras model has not seen data "
                               "yet, so it has no weights to save")

    def load_orca_checkpoint(self, path: str,
                             version: Optional[int] = None) -> "Estimator":
        """Restore the newest committed (or the `version`) checkpoint of
        the directory `path`."""
        return self.load(ckpt_mod.find_latest_checkpoint(path, version))

    @property
    def epoch(self) -> int:
        """The epoch cursor: epochs completed so far (`fit` trains
        `epochs` more from here)."""
        return self._epoch

    def resume_latest(self) -> Optional[str]:
        """Restore the newest committed checkpoint under `model_dir`,
        the epoch cursor from its sidecar included.  Returns its path,
        or None when nothing committed exists yet."""
        if not self.model_dir:
            raise ValueError("resume_latest needs model_dir")
        try:
            path = ckpt_mod.find_latest_checkpoint(self.model_dir)
        except (FileNotFoundError, OSError):
            return None
        self.load(path)
        try:
            with open(path + ".meta.json") as f:
                # epochs completed at save time
                self._epoch = int(json.load(f)["epoch"])
        except (FileNotFoundError, OSError, KeyError, ValueError):
            pass
        return path

    # ------------------------------------------------------------------
    # summaries
    # ------------------------------------------------------------------

    def set_tensorboard(self, log_dir: str, app_name: str) -> "Estimator":
        """Write TensorBoard event files under
        `log_dir/app_name/{train,validation}`."""
        from analytics_zoo_tpu_torch.utils.summary import SummaryWriter
        base = os.path.join(log_dir, app_name)
        self._tb_writers = {
            "train": SummaryWriter(os.path.join(base, "train")),
            "validation": SummaryWriter(os.path.join(base, "validation")),
        }
        return self

    def _tb_log(self, split: str, stats: Dict[str, Any], step: int):
        if not self._tb_writers:
            return
        scalars = {k: float(v) for k, v in stats.items()
                   if isinstance(v, (int, float)) and k not in
                   ("epoch", "step")}
        self._tb_writers[split].add_scalars(scalars, step)

    def get_train_summary(self, tag: str):
        """(step, value) rows of a stat, one per epoch."""
        return [(s["step"], s[tag]) for s in self.train_summary if tag in s]

    def get_validation_summary(self, tag: str):
        return [(s["step"], s[tag]) for s in self.val_summary if tag in s]
