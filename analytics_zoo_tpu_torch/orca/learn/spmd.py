"""The training engine on one card (counterpart of
analytics_zoo_tpu/orca/learn/spmd.py's `SPMDEngine`, without the mesh,
the device data store and the epoch scan).

`TrainEngine` runs a torch module's train, eval and predict steps on
padded host batches.  The train step is `_train_step_impl`'s
(spmd.py:354-408): the masked-mean loss over the real rows, its
backward, a non-finite check over the loss and every gradient, the
update skipped on the device when that check fails (the fused
optimizer's `found_inf`: parameters and optimizer state keep their
values, and the host never waits on the check), and per-step stats with
`_count` (real rows, 0 on a skipped step) and `_nan_steps`.
`run_epoch` keeps the stats on the device and reads them back once per
epoch.  One `torch.Generator` on the
module's device, seeded from `seed`, gives every dropout mask and flash
dropout seed; the module gets it as its `generator` argument in
training.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, List, Optional

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
        """One pass; returns the count-weighted means of the stats over
        the real rows (plus `nan_steps` when a step was skipped) and
        keeps each step's stats in `last_steps`, all read back from the
        device in one transfer at the end of the pass."""
        keys, rows = None, []
        for host_batch in batch_iter:
            batch = self.put_batch(host_batch)
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
