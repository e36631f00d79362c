"""The training engine on one card (counterpart of
analytics_zoo_tpu/orca/learn/spmd.py's `SPMDEngine`, without the mesh
and the epoch scan).

`TrainEngine` runs a torch module's train, eval and predict steps on
padded batches.  The train step is `_train_step_impl`'s
(spmd.py:354-408): the masked-mean loss over the real rows, its
backward, a non-finite check over the loss and every gradient, the
update skipped on the device when that check fails (the fused
optimizer's `found_inf`: parameters and optimizer state keep their
values, and the host never waits on the check), and per-step stats with
`_count` (real rows, 0 on a skipped step) and `_nan_steps`.
`run_epoch` takes host batches and copies each to the card;
`run_epoch_device` takes a `DeviceDataset` (the DEVICE data store,
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
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from analytics_zoo_tpu_torch.orca.learn.optimizers import Optimizer


def masked_mean(values, mask):
    """Mean over real (unpadded) examples; trailing dims of the
    per-example `values` are averaged per example first."""
    values = values.reshape(values.shape[0], -1).mean(dim=1)
    return (values * mask).sum() / mask.sum().clamp_min(1.0)


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
                 seed: int = 0):
        params = list(model.parameters())
        if not params:
            raise ValueError("the module has no parameters to train")
        self.model = model
        self.device = params[0].device
        self.params = [p for p in params if p.requires_grad]
        self.optimizer = optimizer
        self.opt = optimizer.build(self.params)
        self.loss_fn = loss_fn
        self.metric_fns = dict(metric_fns or {})
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._takes_generator = _declares(model.forward, "generator")
        self.host_step = 0
        #: each step's stats of the last run_epoch, as host floats
        self.last_steps: List[Dict[str, float]] = []

    def put_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                self.device, non_blocking=True)
        return {"features": tuple(put(a) for a in batch["features"]),
                "labels": tuple(put(a) for a in batch["labels"]),
                "mask": put(batch["mask"])}

    def _forward(self, features, training: bool):
        self.model.train(training)
        if training and self._takes_generator:
            return self.model(*features, generator=self.generator)
        return self.model(*features)

    def train_step(self, batch) -> Dict[str, torch.Tensor]:
        mask = batch["mask"]
        self.opt.zero_grad(set_to_none=True)
        preds = self._forward(batch["features"], True)
        loss = masked_mean(self.loss_fn(preds, batch["labels"]), mask)
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
        self.optimizer.clip_(grads, norm)
        # a non-finite step is skipped on the device, with no host read
        self.opt.found_inf = (~finite).float()
        self.opt.step()
        self.host_step += 1
        fin = finite.float()
        with torch.no_grad():
            stats = {"loss": torch.where(finite, loss.detach(), 0.0)}
            for name, fn in self.metric_fns.items():
                m = masked_mean(fn(preds, batch["labels"]), mask)
                stats[name] = torch.where(finite, m, 0.0)
        stats["_count"] = mask.sum() * fin
        stats["_nan_steps"] = 1.0 - fin
        return stats

    @torch.no_grad()
    def eval_step(self, batch) -> Dict[str, torch.Tensor]:
        preds = self._forward(batch["features"], False)
        mask = batch["mask"]
        stats = {}
        if batch["labels"]:
            if self.loss_fn is not None:
                stats["loss"] = masked_mean(
                    self.loss_fn(preds, batch["labels"]), mask)
            for name, fn in self.metric_fns.items():
                stats[name] = masked_mean(fn(preds, batch["labels"]), mask)
        stats["_count"] = mask.sum()
        return stats

    def run_epoch(self, batch_iter, train: bool = True) -> Dict[str, float]:
        """One pass over host batches; returns the count-weighted means
        of the stats over the real rows (plus `nan_steps` when a step was
        skipped) and keeps each step's stats in `last_steps`, all read
        back from the device in one transfer at the end of the pass."""
        return self._run(map(self.put_batch, batch_iter), train)

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
                         epoch: int = 0) -> Dict[str, float]:
        """`run_epoch` over a `DeviceDataset`: step i indexes data[i] on
        the device, with no host-to-device copy; with `shuffle`, one
        device-side permutation of all rows per epoch."""
        data = dds.shuffled(seed, epoch) if shuffle else dds.data
        batches = ({"features": tuple(a[i] for a in data["features"]),
                    "labels": tuple(a[i] for a in data["labels"]),
                    "mask": data["mask"][i]} for i in range(dds.steps))
        return self._run(batches, train)

    def _run(self, batches, train: bool) -> Dict[str, float]:
        keys, rows = None, []
        for batch in batches:
            stats = self.train_step(batch) if train else \
                self.eval_step(batch)
            keys = list(stats)
            rows.append(torch.stack([stats[k].float() for k in keys]))
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

    @torch.no_grad()
    def predict_all(self, batch_iter) -> List[Any]:
        """Predictions per batch as numpy, padding rows dropped."""
        outs = []
        for host_batch in batch_iter:
            n_real = int(host_batch["mask"].sum())
            batch = self.put_batch(host_batch)
            outs.append(_strip(self._forward(batch["features"], False),
                               n_real))
        return outs


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
