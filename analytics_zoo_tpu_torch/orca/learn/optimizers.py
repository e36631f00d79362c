"""Optimizer resolution (counterpart of
analytics_zoo_tpu/orca/learn/optimizers.py, whose optimizers are optax
transformations).

Each factory returns an `Optimizer`: not yet bound to parameters,
`build(params)` makes the fused torch.optim optimizer that computes the optax
update (`torch.optim.Adam` is optax's adam: bias-corrected moments, eps
outside the square root; `AdamW` is optax's adamw, the decay decoupled
and taken on the parameters before the step; `SGD`'s momentum trace and
added weight decay are optax's `sgd` after `add_decayed_weights`).
`resolve` adds the gradient clipping of the reference Estimator:
`clip_norm` (optax.clip_by_global_norm) and `clip_value` (a bound or a
(min, max) pair), applied before the update, in that order.
Learning-rate schedules are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch


@dataclasses.dataclass
class Optimizer:
    """A torch.optim class and its arguments, plus gradient clipping."""
    cls: type
    kwargs: Dict[str, Any]
    clip_norm: Optional[float] = None
    clip_value: Any = None

    def build(self, params) -> torch.optim.Optimizer:
        """The fused torch.optim optimizer: it skips the whole update on
        the device where its `found_inf` attribute holds 1."""
        params = list(params)
        opt = self.cls(params, fused=True, **self.kwargs)
        if self.kwargs.get("momentum"):
            # optax's trace starts at zero; fused SGD would leave a
            # skipped first step an uninitialized momentum buffer
            for p in params:
                opt.state[p]["momentum_buffer"] = torch.zeros_like(p)
        return opt

    def clip_(self, grads, global_norm) -> None:
        """Clip `grads` in place: by the global L2 norm `global_norm` (a
        tensor, the norm of all of `grads`), then elementwise."""
        if self.clip_norm:
            # optax: g unchanged below the bound, else g / norm * bound
            coef = torch.where(global_norm < self.clip_norm,
                               torch.ones_like(global_norm),
                               self.clip_norm / global_norm)
            for g in grads:
                g.mul_(coef.to(g.dtype))
        if self.clip_value is not None:
            if isinstance(self.clip_value, (tuple, list)):
                lo, hi = (float(v) for v in self.clip_value)
            elif self.clip_value:
                lo, hi = -float(self.clip_value), float(self.clip_value)
            else:
                return
            for g in grads:
                g.clamp_(lo, hi)


def _no_schedule(schedule) -> None:
    if schedule is not None:
        raise NotImplementedError(
            "learning-rate schedules are not ported yet (ROADMAP Queue 1); "
            "pass a constant learning_rate")


def SGD(learning_rate=1e-2, momentum=0.0, nesterov=False, weight_decay=0.0,
        learningrate_schedule=None) -> Optimizer:
    _no_schedule(learningrate_schedule)
    return Optimizer(torch.optim.SGD, dict(
        lr=learning_rate, momentum=momentum,
        nesterov=bool(nesterov and momentum), weight_decay=weight_decay))


def Adam(learning_rate=1e-3, beta1=0.9, beta2=0.999, epsilon=1e-8,
         learningrate_schedule=None) -> Optimizer:
    _no_schedule(learningrate_schedule)
    return Optimizer(torch.optim.Adam, dict(lr=learning_rate,
                                            betas=(beta1, beta2),
                                            eps=epsilon))


def AdamWeightDecay(learning_rate=1e-3, weight_decay=0.01, beta1=0.9,
                    beta2=0.999, epsilon=1e-6,
                    learningrate_schedule=None) -> Optimizer:
    """The BERT optimizer (reference scala keras AdamWeightDecay)."""
    _no_schedule(learningrate_schedule)
    return Optimizer(torch.optim.AdamW, dict(
        lr=learning_rate, betas=(beta1, beta2), eps=epsilon,
        weight_decay=weight_decay))


_REGISTRY = {"sgd": SGD, "adam": Adam, "adamw": AdamWeightDecay,
             "adamweightdecay": AdamWeightDecay}
_NOT_PORTED = ("rmsprop", "adagrad", "adadelta")


def resolve(optimizer, learning_rate: Optional[float] = None,
            clip_norm: Optional[float] = None,
            clip_value=None) -> Optimizer:
    """An `Optimizer`, a registry name, or None (adam), with the
    clipping set.  `learning_rate` is passed only when given, so each
    optimizer's own default holds (and an explicit 0.0 is honored)."""
    lr_kwargs = {} if learning_rate is None else {
        "learning_rate": learning_rate}
    if optimizer is None:
        opt = Adam(**lr_kwargs)
    elif isinstance(optimizer, str):
        key = optimizer.lower()
        if key in _NOT_PORTED:
            raise NotImplementedError(
                f"optimizer {optimizer!r} is not ported yet; ported: "
                f"{sorted(_REGISTRY)}")
        if key not in _REGISTRY:
            raise ValueError(f"unknown optimizer {optimizer!r}; known: "
                             f"{sorted(_REGISTRY)}")
        opt = _REGISTRY[key](**lr_kwargs)
    elif isinstance(optimizer, Optimizer):
        opt = optimizer
    else:
        raise TypeError(f"cannot resolve optimizer from {optimizer!r}")
    return dataclasses.replace(opt, clip_norm=clip_norm,
                               clip_value=clip_value)
