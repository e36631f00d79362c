"""The training engine on one card (counterpart of
analytics_zoo_tpu/orca/learn/spmd.py's `SPMDEngine`, without the mesh
and the epoch scan).

`TrainEngine` runs a torch module's train, eval and predict steps on
padded batches.  The train step is `_train_step_impl`'s
(spmd.py:354-408): the masked-mean loss over the real rows, its
backward, a non-finite check over the loss and every gradient, the
update skipped on the device when that check fails (the fused
optimizer's `found_inf`: parameters and optimizer state keep their
values, module buffers are put back from a copy taken before the
forward, and the host never waits on the check), and per-step stats with
`_count` (real rows, 0 on a skipped step) and `_nan_steps`.
With `aux_loss_weight` the module returns `(predictions, aux)` (JAX
spmd.py:126-142): a `[batch]` aux is masked-mean'd over the real rows
(`_split_aux`, spmd.py:337-347), the step minimizes `loss + weight *
aux` and reports the data loss as `loss` and the aux term as
`aux_loss` (zero on a skipped step), evaluate reports `aux_loss` too,
and predict drops it.
`run_epoch` takes host batches and copies each to the card, double
buffered (`_HostPrefetcher`, `OrcaContext.host_input_prefetch`): the
loop pops a batch already staged and stages the next one right after
it queues the current step, on the same thread, through a ring of
pinned host buffers (`PinnedRing`); `run_epoch_device` takes a
`DeviceDataset` (the DEVICE data store,
uploaded once by `cache_dataset`) and indexes its steps in place, with
no host-to-device copy.  Both keep the stats on the device and read
them back once per epoch.  One `torch.Generator` on the module's
device, seeded from `seed`, gives every dropout mask and flash dropout
seed; the module gets it as its `generator` argument in training.

The DEVICE store's shuffle permutes all steps x batch rows, padding
rows included, on the device, as JAX's `_shuffle_impl`
(spmd.py:303-318) does; the permutation comes from a `torch.Generator`
seeded by (seed, epoch), so its order differs from
`jax.random.permutation`'s.  JAX runs a DEVICE epoch as one unguarded
scan and replays it guarded on a non-finite step (spmd.py:505-560), a
device for XLA's speed; here each step is guarded as it runs, with the
same results.

Each loop fires the fault site `train.step` before every training step
and, on the DEVICE store, `train.epoch` at the top of the epoch (JAX
spmd.py:499, :580, :812; here the DEVICE epoch is always a per-step
loop, so `train.step` fires on it too, where JAX's one-dispatch epoch
program fires only `train.epoch`).  `on_step(step)` is called after
each step with the loop-local step, which the loop commits to
`host_step` only at its end (as JAX's host mirror): a step-granular
checkpoint trigger must take that local step.  `step` counts every
train step run (JAX's `state.step`, skipped steps included);
`sync_host_step` resets the mirror to it.  `state_dict` /
`load_state_dict` carry all a resumed run needs: the module's and the
optimizer's state dicts (the fused optimizer's device `step` tensors
included), the schedule's step count, the dropout generator's state
and `step`.  `profile=True` fences every step and keeps its host wall
time (and the schedule's learning rate) in `last_profile`.

Observability (JAX spmd.py:206-240, :680-762): each step runs in an
`spmd.step` span and a goodput step record of the `spmd_train` /
`spmd_eval` clock (laps `host_input`, `compile` on this engine's first
dispatch of a signature, `device_compute` for the wait at a fence after
the dispatch returned, on the sampled steps), and goes through the
dispatch ledger's `train_step` / `eval_step` family, which counts its
signatures; fenced steps report their wall and `6·P` (train) / `2·P`
(eval) FLOPs per row to the ledger.  The engine's first dispatch of a
step signature (its wrapper's `last_call_new`; predict's forward has a
wrapper with no ledger family) is where the kernels' first launch
builds them on the card: its span carries `jit_cold` and its duration
goes to the `torch_first_dispatch_seconds` histogram (JAX's
`jax_jit_compile_seconds`).  Every step leaves an `spmd_step` flight
record and beats the `watchdog` an owner (`Estimator.fit`) assigns.
With `OrcaContext.nonfinite_watchdog` the host reads each step's
`_nan_steps` (one sync a step) and, on a skipped step, recomputes the
batch's forward, loss and gradients from the kept pre-step state (the
parameters the skipped update left, the dropout generator's state from
before the step), names the nonfinite tensors in the order parameters
-> predictions -> per-example loss -> loss -> gradients, and writes a
`nonfinite_step` event and bundle.  The DEVICE store's epoch is a loop
of steps here, so it emits these per-step spans and records too; JAX's
one-dispatch epoch scan emits one `spmd.epoch_scan` span instead.
"""

from __future__ import annotations

import inspect
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.observability import (
    RENAMED_FROM_JAX,
    annotate,
    flight_recorder,
    get_registry,
    localize_nonfinite,
    log_event,
    now,
    profiling,
    step_clock,
    trace,
)
from analytics_zoo_tpu_torch.orca.learn.optimizers import Optimizer
from analytics_zoo_tpu_torch.resilience.faults import fault_point

#: the histogram of a step signature's first dispatch
FIRST_DISPATCH_SECONDS = RENAMED_FROM_JAX["jax_jit_compile_seconds"]


def masked_mean(values, mask):
    """Mean over real (unpadded) examples; trailing dims of the
    per-example `values` are averaged per example first."""
    values = values.reshape(values.shape[0], -1).mean(dim=1)
    return (values * mask).sum() / mask.sum().clamp_min(1.0)


def _buffer_groups(model: torch.nn.Module) -> List[List[torch.Tensor]]:
    """The module's buffers grouped by (dtype, device), in module order."""
    groups: Dict[Any, List[torch.Tensor]] = {}
    for b in model.buffers():
        groups.setdefault((b.dtype, b.device), []).append(b)
    return list(groups.values())


def snapshot_buffers(model: torch.nn.Module) -> List[torch.Tensor]:
    """One flat copy per dtype of the module's buffers, taken before a
    training forward; empty (and free) for a module without buffers."""
    return [torch.cat([b.detach().reshape(-1) for b in g])
            for g in _buffer_groups(model)]


def restore_buffers(model: torch.nn.Module, saved: List[torch.Tensor],
                    finite: torch.Tensor) -> None:
    """Put `saved` back into the module's buffers where the step is not
    `finite` (a 0-d bool tensor), on the device with no host read: a
    skipped step leaves BatchNorm's running stats and count as they were,
    as JAX keeps its model state (spmd.py:386-392).  A few launches per
    dtype, however many buffers."""
    if not saved:
        return
    with torch.no_grad():
        for g, old in zip(_buffer_groups(model), saved):
            keep = torch.where(finite, torch.cat([b.reshape(-1) for b in g]),
                               old)
            parts = keep.split([b.numel() for b in g])
            torch._foreach_copy_(g, [v.view_as(b) for v, b in zip(parts, g)])


def _declares(fn, name: str) -> bool:
    try:
        return name in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


class DeviceDataset:
    """A whole dataset on the card as [steps, batch, ...] tensors: the
    DEVICE data store (counterpart of JAX `DeviceDataset`, spmd.py:59).
    Built by `TrainEngine.cache_dataset`."""

    def __init__(self, data: Dict[str, Any], steps: int, batch: int,
                 n_real: int, nbytes: int):
        self.data = data          # {"features": (...), "labels": (...),
        #                            "mask": [steps, batch]}
        self.steps = steps
        self.batch = batch
        self.n_real = n_real
        self.nbytes = nbytes

    def shuffled(self, seed: int, epoch: int) -> Dict[str, Any]:
        """`data` with its steps x batch rows, padding included, in one
        permutation drawn on the device from (seed, epoch)."""
        mask = self.data["mask"]
        gen = torch.Generator(device=mask.device)
        gen.manual_seed(int(np.random.SeedSequence([seed, epoch])
                            .generate_state(1, np.uint64)[0] >> 1))
        perm = torch.randperm(self.steps * self.batch, generator=gen,
                              device=mask.device)

        def take(a):
            flat = a.reshape(self.steps * self.batch, *a.shape[2:])
            return flat[perm].reshape(a.shape)
        return {"features": tuple(take(a) for a in self.data["features"]),
                "labels": tuple(take(a) for a in self.data["labels"]),
                "mask": take(mask)}


class PinnedRing:
    """Host batches staged to the card through a ring of pinned host
    buffers (the counterpart of JAX's asynchronous `device_put`).

    `put` writes a batch's arrays into the next slot's pinned buffer
    (numpy copies, each array at a 256-byte aligned offset), queues one
    copy of the slot to the card with `non_blocking=True` and returns
    typed views of the device copy; an event recorded after the copy
    marks when the slot may be written again.  A copy from pageable
    memory cannot overlap the card's work (CUDA stages it through a
    bounce buffer and the host waits for the stream); one from pinned
    memory is queued and returns.  Before a slot is written again the
    host waits on its event: without the wait, batch k+d+1 would
    overwrite batch k+1's bytes while their copy may still be running.
    A slot's buffer grows only when a batch's bytes outgrow it.  `waits`
    counts the puts that found their slot's copy still running."""

    ALIGN = 256

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.buffers: List[Optional[torch.Tensor]] = [None] * slots
        self._host: List[Optional[np.ndarray]] = [None] * slots
        self.events: List[Optional[Any]] = [None] * slots
        self.next = 0
        self.waits = 0
        self.puts = 0

    @property
    def slots(self) -> int:
        return len(self.buffers)

    @property
    def nbytes(self) -> int:
        return sum(b.numel() for b in self.buffers if b is not None)

    def put(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        arrays = [np.asarray(a) for a in (*batch["features"],
                                          *batch["labels"], batch["mask"])]
        offsets, total = [], 0
        for a in arrays:
            offsets.append(total)
            total += -(-a.nbytes // self.ALIGN) * self.ALIGN
        i = self.next
        self.next = (i + 1) % self.slots
        event = self.events[i]
        if event is not None:
            if not event.query():
                self.waits += 1
            event.synchronize()
        if self.buffers[i] is None or self.buffers[i].numel() < total:
            self.buffers[i] = self._alloc(max(total, 1))
            self._host[i] = self.buffers[i].numpy()
        host = self._host[i]
        for a, off in zip(arrays, offsets):
            np.copyto(host[off:off + a.nbytes].view(a.dtype).reshape(a.shape),
                      a)
        dev = self.buffers[i][:total].to(self.device, non_blocking=True)
        if event is None:
            event = self.events[i] = self._event()
        event.record()
        self.puts += 1
        staged = [dev[off:off + a.nbytes].view(_torch_dtype(a.dtype))
                  .view(a.shape) for a, off in zip(arrays, offsets)]
        n_feat, n_lab = len(batch["features"]), len(batch["labels"])
        return {"features": tuple(staged[:n_feat]),
                "labels": tuple(staged[n_feat:n_feat + n_lab]),
                "mask": staged[-1]}

    def _alloc(self, nbytes: int) -> torch.Tensor:
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)

    def _event(self):
        return torch.cuda.Event()

    def stats(self) -> Dict[str, int]:
        return {"slots": self.slots, "bytes": self.nbytes,
                "puts": self.puts, "waits": self.waits}


_TORCH_DTYPES: Dict[np.dtype, torch.dtype] = {}


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (cached)."""
    if dtype not in _TORCH_DTYPES:
        _TORCH_DTYPES[dtype] = torch.from_numpy(np.empty(0, dtype)).dtype
    return _TORCH_DTYPES[dtype]


class _HostPrefetcher:
    """Double-buffered host-to-device input staging (JAX
    spmd.py:627-667, `OrcaContext.host_input_prefetch`).

    With depth d >= 1, d batches are staged at construction; the loop
    pops one already staged at the top of each step and calls
    `stage(1)` right after queuing the step, so batch k+1's assembly and
    copy run while step k computes on the card.  No background thread:
    in JAX a Python prefetch thread fought the step's dispatch for the
    GIL.  Depth 0 stages each batch inside its own step."""

    def __init__(self, put: Callable, batch_iter, depth: int):
        self._put = put
        self._it = iter(batch_iter)
        self.depth = max(0, int(depth))
        self._staged = deque()
        self._done = False
        self.stage(self.depth)

    def stage(self, n: int = 1) -> None:
        """Assemble and stage up to `n` more batches."""
        for _ in range(n):
            if self._done:
                return
            try:
                hb = next(self._it)
            except StopIteration:
                self._done = True
                return
            self._staged.append(self._put(hb))

    def pop(self):
        """The next staged batch (staged here when none is buffered, the
        depth-0 path), or None once the batches are exhausted."""
        if not self._staged and not self._done:
            self.stage(1)
        return self._staged.popleft() if self._staged else None


def _strip(preds, n: int):
    """Predictions (a tensor or a tuple of them) to numpy, padding rows
    dropped."""
    if isinstance(preds, (tuple, list)):
        return type(preds)(_strip(p, n) for p in preds)
    return preds[:n].detach().float().cpu().numpy()


class TrainEngine:
    """Train/eval/predict executor for one torch module on its device.

    loss_fn(preds, labels) -> per-example loss (leading dim = batch);
    metric_fns: {name: fn(preds, labels) -> per-example values}."""

    def __init__(self, model: torch.nn.Module, optimizer: Optimizer,
                 loss_fn: Optional[Callable] = None,
                 metric_fns: Optional[Dict[str, Callable]] = None,
                 seed: int = 0, aux_loss_weight: Optional[float] = None):
        params = list(model.parameters())
        # a module without parameters (a Keras graph of stateless layers)
        # evaluates and predicts on the device it names, and cannot train
        device = params[0].device if params else getattr(model, "device",
                                                         None)
        if device is None:
            raise ValueError("the module has no parameters to train")
        self.model = model
        self.device = torch.device(device)
        self.params = [p for p in params if p.requires_grad]
        self.optimizer = optimizer
        self.opt, self.schedule = (optimizer.build(self.params)
                                   if self.params else (None, None))
        self.loss_fn = loss_fn
        self.metric_fns = dict(metric_fns or {})
        #: set when the module returns (predictions, aux): the train
        #: loss adds weight * aux; metrics see the predictions alone
        self.aux_loss_weight = aux_loss_weight
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._takes_generator = _declares(model.forward, "generator")
        # pairwise losses (rank_hinge) need the padding mask inside the
        # loss, so a loss declaring `mask` gets it (JAX spmd.py:147-150)
        self._loss_takes_mask = (loss_fn is not None
                                 and _declares(loss_fn, "mask"))
        #: the pinned staging ring of the host-streaming loops (on the
        #: card, depth >= 1), made on first use
        self.ring: Optional[PinnedRing] = None
        #: train steps run (skipped ones included); `host_step` is the
        #: loops' mirror of it, committed at the end of each loop
        self.step = 0
        self.host_step = 0
        #: each step's stats of the last run_epoch, as host floats
        self.last_steps: List[Dict[str, float]] = []
        #: per-step host wall times of the last profiled loop
        self.last_profile: List[Dict[str, float]] = []
        self.param_count = sum(p.numel() for p in model.parameters())
        #: goodput step clocks (observability/goodput.py)
        self._clock_train = step_clock("spmd_train")
        self._clock_eval = step_clock("spmd_eval")
        #: the stall watchdog an owner (Estimator.fit) assigns; the step
        #: loops beat it once a step
        self.watchdog = None
        # the dispatch ledger's step families; the lambdas read the
        # methods at call time, so a wrapper assigned to the instance's
        # `train_step` is the one the ledger calls
        self._train_step = profiling.instrument(
            "train_step", lambda batch: self.train_step(batch),
            argnames=("batch",))
        self._eval_step = profiling.instrument(
            "eval_step", lambda batch: self.eval_step(batch),
            argnames=("batch",))
        # predict's forward: no ledger family (as in JAX), only the
        # wrapper's first-dispatch flag
        self._predict_step = profiling.instrument(
            None, lambda features: self._forward(features, False))

    def put_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                self.device, non_blocking=True)
        return {"features": tuple(put(a) for a in batch["features"]),
                "labels": tuple(put(a) for a in batch["labels"]),
                "mask": put(batch["mask"])}

    def _stager(self):
        """(the function staging a host batch on the device, the
        prefetch depth): on the card at depth d >= 1 the pinned ring of
        d + 1 slots; at depth 0 the synchronous `put_batch`; on the CPU
        `put_batch`, which is `torch.from_numpy`."""
        depth = OrcaContext.host_input_prefetch
        if self.device.type != "cuda" or depth == 0:
            return self.put_batch, depth
        if self.ring is None or self.ring.slots < depth + 1:
            self.ring = PinnedRing(self.device, depth + 1)
        return self.ring.put, depth

    def _per_example_loss(self, preds, labels, mask):
        if self._loss_takes_mask:
            return self.loss_fn(preds, labels, mask=mask)
        return self.loss_fn(preds, labels)

    def _forward(self, features, training: bool, generator=None):
        self.model.train(training)
        if training and self._takes_generator:
            return self.model(*features,
                              generator=generator or self.generator)
        return self.model(*features)

    def _split_aux(self, preds, mask=None):
        """(predictions, aux or None) per `aux_loss_weight`: a scalar aux
        as it is, a per-example `[batch]` aux masked-mean'd over the real
        rows, so the padding of a ragged tail never biases it."""
        if self.aux_loss_weight is None:
            return preds, None
        preds, aux = preds
        if aux is not None and aux.dim() == 1 and mask is not None:
            aux = masked_mean(aux, mask)
        return preds, aux

    def train_step(self, batch) -> Dict[str, torch.Tensor]:
        if self.opt is None:
            raise ValueError("the module has no parameters to train")
        mask = batch["mask"]
        self.opt.zero_grad(set_to_none=True)
        # the forward updates buffers (BatchNorm's running stats and
        # count) before the step is known finite
        saved = snapshot_buffers(self.model)
        preds, aux = self._split_aux(self._forward(batch["features"], True),
                                     mask)
        data_loss = masked_mean(self._per_example_loss(
            preds, batch["labels"], mask), mask)
        loss = data_loss if aux is None else \
            data_loss + self.aux_loss_weight * aux
        loss.backward()
        grads = [p.grad for p in self.params if p.grad is not None]
        finite = torch.isfinite(loss.detach())
        norm = loss.new_zeros(())
        if grads:
            # per element, as JAX's all(isfinite(g)): the largest |g| is
            # inf only at an inf element, and the L2 norm is nan only at
            # a nan one; finite elements above ~1.8e19 overflow the L2
            # norm to inf without making the step non-finite (optax then
            # clips by clip_norm / inf = 0)
            norm = torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm(grads)))
            amax = torch.stack(torch._foreach_norm(grads, ord=float("inf")))
            finite = finite & ~torch.isnan(norm) & torch.isfinite(amax).all()
        # after the backward, so remat's recomputed forward is undone too
        restore_buffers(self.model, saved, finite)
        self.optimizer.clip_(grads, norm)
        fin = finite.float()
        if self.schedule is not None:
            self.schedule.before_step()
        # a non-finite step is skipped on the device, with no host read
        self.opt.found_inf = 1.0 - fin
        self.opt.step()
        if self.schedule is not None:
            # optax keeps its count on a skipped step
            self.schedule.after_step(fin)
        self.step += 1
        with torch.no_grad():
            # the data loss, so train and eval losses compare 1:1
            stats = {"loss": torch.where(finite, data_loss.detach(), 0.0)}
            if aux is not None:
                stats["aux_loss"] = torch.where(finite, aux.detach(), 0.0)
            for name, fn in self.metric_fns.items():
                m = masked_mean(fn(preds, batch["labels"]), mask)
                stats[name] = torch.where(finite, m, 0.0)
        stats["_count"] = mask.sum() * fin
        stats["_nan_steps"] = 1.0 - fin
        return stats

    @torch.no_grad()
    def eval_step(self, batch) -> Dict[str, torch.Tensor]:
        mask = batch["mask"]
        preds, aux = self._split_aux(self._forward(batch["features"], False),
                                     mask)
        stats = {}
        if aux is not None:
            stats["aux_loss"] = aux
        if batch["labels"]:
            if self.loss_fn is not None:
                stats["loss"] = masked_mean(
                    self._per_example_loss(preds, batch["labels"], mask),
                    mask)
            for name, fn in self.metric_fns.items():
                stats[name] = masked_mean(fn(preds, batch["labels"]), mask)
        stats["_count"] = mask.sum()
        return stats

    def run_epoch(self, batch_iter, train: bool = True,
                  on_step: Optional[Callable[[int], None]] = None,
                  profile: bool = False) -> Dict[str, float]:
        """One pass over host batches; returns the count-weighted means
        of the stats over the real rows (plus `nan_steps` when a step was
        skipped) and keeps each step's stats in `last_steps`, all read
        back from the device in one transfer at the end of the pass.
        The batches are staged `OrcaContext.host_input_prefetch` ahead
        (`_HostPrefetcher`).  `on_step(step)` follows each training step
        (the loop-local step); `profile` fences each step and times
        it."""
        put, depth = self._stager()
        return self._run(_HostPrefetcher(put, batch_iter, depth), train,
                         on_step, profile)

    @staticmethod
    def cached_layout(n: int, batch_size: int):
        """(steps, batch) of the DEVICE store's layout: the host path's
        batches, `batch_size` real rows a step (fewer in the last)."""
        return max(1, -(-n // batch_size)), batch_size

    def cache_dataset(self, features: Sequence[np.ndarray],
                      labels: Sequence[np.ndarray],
                      batch_size: int) -> DeviceDataset:
        """Upload the whole dataset once as [steps, batch, ...] tensors
        on the module's device, the last step zero-padded with its mask:
        the same batches, steps and masks as the host path."""
        n = len(features[0]) if features else len(labels[0])
        steps, b = self.cached_layout(n, batch_size)

        def prep(a):
            a = np.asarray(a)
            out = np.zeros((steps * b,) + a.shape[1:], a.dtype)
            out[:n] = a
            return out.reshape((steps, b) + a.shape[1:])

        host = {"features": tuple(prep(a) for a in features),
                "labels": tuple(prep(a) for a in labels),
                "mask": prep(np.ones(n, np.float32))}
        nbytes = sum(a.nbytes for a in (*host["features"], *host["labels"],
                                        host["mask"]))
        return DeviceDataset(self.put_batch(host), steps, b, n, nbytes)

    def run_epoch_device(self, dds: DeviceDataset, train: bool = True,
                         shuffle: bool = False, seed: int = 0,
                         epoch: int = 0,
                         on_step: Optional[Callable[[int], None]] = None,
                         profile: bool = False) -> Dict[str, float]:
        """`run_epoch` over a `DeviceDataset`: step i indexes data[i] on
        the device, with no host-to-device copy; with `shuffle`, one
        device-side permutation of all rows per epoch."""
        fault_point("train.epoch" if train else "eval.epoch", epoch=epoch)
        data = dds.shuffled(seed, epoch) if shuffle else dds.data
        batches = ({"features": tuple(a[i] for a in data["features"]),
                    "labels": tuple(a[i] for a in data["labels"]),
                    "mask": data["mask"][i]} for i in range(dds.steps))
        return self._run(_HostPrefetcher(lambda b: b, batches, 0), train,
                         on_step, profile,
                         kind="train_cached" if train else "eval_cached")

    def _fence(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run(self, pre: _HostPrefetcher, train: bool, on_step=None,
             profile: bool = False, kind: str = "") -> Dict[str, float]:
        annotate(mesh={"dp": 1})
        kind = kind or ("train" if train else "eval")
        keys, rows = None, []
        # the loop-local step, committed to host_step at the end
        step = self.host_step if train else 0
        profiled = []
        clock = self._clock_train if train else self._clock_eval
        step_fn = self._train_step if train else self._eval_step
        sentinel = train and OrcaContext.nonfinite_watchdog
        while True:
            rec = clock.begin(force_fence=profile or sentinel)
            # with prefetch a batch staged during the previous step; at
            # depth 0 it is staged here, inside this step
            batch = pre.pop()
            if batch is None:
                break
            rec.lap("host_input")
            # "raise" / "crash" kill the worker here, "stall" wedges the
            # loop for the watchdogs, "nan" poisons this host batch
            # (JAX spmd.py:808-815; the DEVICE store's steps, as JAX's
            # cached loop, fire the site and poison nothing)
            act = fault_point("train.step" if train else "eval.step",
                              step=step + 1 if train else step)
            if act == "nan" and train and kind == "train":
                batch = _poison_batch_nan(batch)
            if profile:
                self._fence()
            # the dropout draws of this step, kept for the sentinel's
            # recompute (a host copy of the generator's seed and offset)
            gen_state = self.generator.get_state() if sentinel else None
            t0 = now()
            with self._step_span(step + 1 if train else step,
                                 train) as sp:
                stats = step_fn(batch)
                rec.cold = step_fn.last_call_new
                if rec.cold:
                    sp.attrs["jit_cold"] = True
            rec.lap("compile" if rec.cold else None)
            if pre.depth > 0:
                # double buffering: stage the next batch while this
                # step runs on the card
                pre.stage(1)
            if train:
                step += 1
            if rec.fenced:
                self._fence()
                rec.lap("device_compute")
                bsz = _batch_rows(batch)
                profiling.record_work(
                    "train_step" if train else "eval_step",
                    now() - t0, tokens=bsz,
                    flops=profiling.train_step_flops(
                        self.param_count, bsz, train))
            if profile:
                row = {"step": step, "step_time_s": now() - t0}
                if train and self.schedule is not None:
                    row["lr"] = float(self.schedule.lr)
                profiled.append(row)
            if sentinel:
                self._sentinel_check(stats, batch, step, gen_state)
            keys = list(stats)
            rows.append(torch.stack([stats[k].float() for k in keys]))
            flight_recorder.record("spmd_step", loop=kind, step=step)
            if self.watchdog is not None:
                self.watchdog.beat()
            if train and on_step is not None:
                on_step(step)
            rec.end()
        if train:
            self.host_step = step
        self.last_profile = profiled
        self.last_steps = []
        if not rows:
            return {}
        self.last_steps = [dict(zip(keys, r))
                           for r in torch.stack(rows).tolist()]
        totals = dict.fromkeys(keys, 0.0)
        for step in self.last_steps:
            for k, v in step.items():
                totals[k] += v if k.startswith("_") else v * step["_count"]
        return _finalize(totals)

    @contextmanager
    def _step_span(self, step: int, train: bool):
        """Span around one step's dispatch.  The caller marks the span
        `jit_cold` on a signature's first dispatch, whose duration then
        goes to the first-dispatch histogram; other dispatches return
        before the card finishes, so their spans time the dispatch."""
        with trace("spmd.step", step=step, train=train) as sp:
            yield sp
        if sp.attrs.get("jit_cold"):
            get_registry().histogram(
                FIRST_DISPATCH_SECONDS,
                help="wall time of a step signature's first dispatch "
                     "(the kernels' first launch builds them)",
            ).record(sp.duration_s)

    # ------------------------------------------------------------------
    # nonfinite sentinel (opt-in: OrcaContext.nonfinite_watchdog)
    # ------------------------------------------------------------------

    def _sentinel_check(self, stats, batch, step: int, gen_state) -> None:
        """Read the step's `_nan_steps` (the host read is the sentinel's
        only cost on a finite step) and, on a trip, localize, record and
        dump.  One bundle per offending step."""
        if float(stats["_nan_steps"]) == 0.0:
            return
        found = self.localize_step_nonfinite(batch, gen_state)
        get_registry().counter(
            "nonfinite_steps_total",
            help="training steps the nonfinite sentinel tripped on"
        ).inc()
        paths = [f["path"] for f in found]
        flight_recorder.record("nonfinite_step", step=step,
                               leaves=paths)
        log_event("nonfinite_step", step=step, leaves=found)
        flight_recorder.dump("nonfinite_step",
                             extra={"step": step, "leaves": found})

    def localize_step_nonfinite(self, batch, gen_state=None
                                ) -> List[Dict[str, Any]]:
        """Recompute the forward, loss and gradients of `batch` from the
        current state (a skipped step left the parameters as they were
        before it) with the dropout generator at `gen_state` (the state
        before the step; None: the current one), and name the nonfinite
        tensors in order across params -> predictions -> per-example
        loss -> loss -> grads (JAX spmd.py:732-762).  The first entry is
        the first nonfinite tensor.  The module's buffers are put back
        after the recompute; no parameter or gradient is touched."""
        model = self.model
        gen = torch.Generator(device=self.device)
        gen.set_state(self.generator.get_state() if gen_state is None
                      else gen_state)
        saved = snapshot_buffers(model)
        mask = batch["mask"]
        try:
            with torch.enable_grad():
                preds, aux = self._split_aux(
                    self._forward(batch["features"], True, gen), mask)
                per_ex = self._per_example_loss(preds, batch["labels"],
                                                mask)
                loss = masked_mean(per_ex, mask)
                if aux is not None:
                    loss = loss + self.aux_loss_weight * aux
                grads = torch.autograd.grad(loss, self.params,
                                            allow_unused=True)
            named = dict(model.named_parameters())
            names = {id(p): n for n, p in named.items()}
            trees = {
                "params": {n: p.detach() for n, p in named.items()},
                "predictions": _detached(preds),
                "per_example_loss": per_ex.detach(),
                "loss": loss.detach(),
                "grads": {names[id(p)]: g
                          for p, g in zip(self.params, grads)
                          if g is not None},
            }
        except Exception as e:  # localization must not mask the event
            return [{"path": "<localization failed: "
                             f"{type(e).__name__}: {e}>"}]
        finally:
            restore_buffers(model, saved,
                            torch.zeros((), dtype=torch.bool,
                                        device=self.device))
        return localize_nonfinite(trees)

    def sync_host_step(self) -> int:
        """Reset the loops' mirror to the steps run (after a restore, or
        after a failed epoch that advanced `step` past the mirror)."""
        self.host_step = self.step
        return self.host_step

    def state_dict(self) -> Dict[str, Any]:
        """All a resumed run needs, by reference (a checkpoint snapshots
        it): the module's and the optimizer's state dicts, the
        schedule's count, the dropout generator's state and `step`."""
        return {"model": self.model.state_dict(),
                "optimizer": (None if self.opt is None
                              else self.opt.state_dict()),
                "schedule_count": (None if self.schedule is None
                                   else self.schedule.count),
                "generator": self.generator.get_state(),
                "step": self.step}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore `state_dict()`'s contents in place (host tensors are
        moved to the engine's device) and resync `host_step`."""
        self.model.load_state_dict(state["model"])
        # the learning rate is the engine's configuration (as in JAX,
        # whose optimizer state holds none): the loaded groups carry the
        # saved one, and a scheduled optimizer must keep reading the
        # schedule's own device tensor
        if self.opt is not None:
            lrs = [group["lr"] for group in self.opt.param_groups]
            self.opt.load_state_dict(state["optimizer"])
            for group, lr in zip(self.opt.param_groups, lrs):
                group["lr"] = lr
        if self.schedule is not None:
            # a checkpoint of an engine without a schedule starts it
            count = state["schedule_count"]
            if count is None:
                self.schedule.count.zero_()
            else:
                self.schedule.count.copy_(count)
            self.schedule.before_step()
        self.generator.set_state(state["generator"])
        self.step = int(state["step"])
        self.sync_host_step()

    @torch.no_grad()
    def predict_all(self, batch_iter) -> List[Any]:
        """Predictions per batch as numpy, padding rows dropped; the
        batches staged ahead as in `run_epoch`, each forward in an
        `spmd.step` span."""
        put, depth = self._stager()
        pre = _HostPrefetcher(lambda hb: (int(hb["mask"].sum()), put(hb)),
                              batch_iter, depth)
        outs = []
        while (item := pre.pop()) is not None:
            n_real, batch = item
            with self._step_span(len(outs), False) as sp:
                preds, _ = self._split_aux(
                    self._predict_step(batch["features"]))
                if self._predict_step.last_call_new:
                    sp.attrs["jit_cold"] = True
                if pre.depth > 0:
                    pre.stage(1)
                outs.append(_strip(preds, n_real))
        return outs


def _poison_batch_nan(batch):
    """The fault plan's "nan" action on one staged batch (JAX
    spmd.py:85): its float feature and label tensors multiplied by NaN,
    new tensors of the same shapes, so the step's finiteness check sees
    the poison as it would an organic NaN and skips the step."""
    def poison(a):
        return a * float("nan") if a.is_floating_point() else a
    out = dict(batch)
    out["features"] = tuple(poison(a) for a in batch["features"])
    out["labels"] = tuple(poison(a) for a in batch["labels"])
    return out


def _batch_rows(batch) -> int:
    """A batch's rows: the leading dim of its first leaf (JAX's
    `tree_leaves(batch)[0].shape[0]`)."""
    return int(profiling.flatten_with_paths(batch)[0][1].shape[0])


def _detached(preds):
    if isinstance(preds, (tuple, list)):
        return type(preds)(_detached(p) for p in preds)
    return preds.detach()


def _finalize(totals: Dict[str, float]) -> Dict[str, float]:
    count = totals.pop("_count")
    nan_steps = totals.pop("_nan_steps", 0.0)
    if count == 0.0 and nan_steps:
        # every step was skipped: loss and metrics are undefined, not 0
        out = {k: float("nan") for k in totals}
    else:
        out = {k: v / max(count, 1.0) for k, v in totals.items()}
    if nan_steps:
        out["nan_steps"] = nan_steps
    return out
