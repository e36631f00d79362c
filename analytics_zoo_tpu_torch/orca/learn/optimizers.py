"""Optimizer resolution (counterpart of
analytics_zoo_tpu/orca/learn/optimizers.py, whose optimizers are optax
transformations).

Each factory returns an `Optimizer`: not yet bound to parameters,
`build(params)` makes the torch optimizer that computes the optax
update.  Adam, AdamW and SGD are the fused torch.optim ones
(`torch.optim.Adam` is optax's adam: bias-corrected moments, eps
outside the square root; `AdamW` is optax's adamw, the decay decoupled
and taken on the parameters before the step; `SGD`'s momentum trace and
added weight decay are optax's `sgd` after `add_decayed_weights`).
RMSprop, Adagrad and Adadelta are written here (`OptaxRMSprop`,
`OptaxAdagrad`, `OptaxAdadelta`): torch.optim's versions compute other
functions (eps outside the square root, accumulators starting at 0) and
have no fused form that reads `found_inf`.
`resolve` adds the gradient clipping of the reference Estimator:
`clip_norm` (optax.clip_by_global_norm) and `clip_value` (a bound or a
(min, max) pair), applied before the update, in that order.

Learning-rate schedules (`Poly`, `Exponential`, `Step`, `Warmup`, the
JAX module's, optimizers.py:19-73) are optax's formulas
(`polynomial_schedule`, `exponential_decay` with and without staircase,
`warmup_cosine_decay_schedule`) on torch tensors in f32.  With a
schedule, `build` hands the fused optimizer a 0-d lr tensor on the
parameters' device, and `LRSchedule` keeps the step count beside it on
the device: before each step the schedule's value at the count is
written into the lr tensor in place, and after it the count advances by
the step's "taken" flag (1, or 0 on a skipped step).  So, as in optax,
the schedule is read at the count before the increment (`Warmup` gives
lr 0 on the first step), a skipped step keeps the count, and the host
never reads the device for it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch

#: a schedule: f32 step count tensor -> f32 learning-rate tensor
ScheduleFn = Callable[[torch.Tensor], torch.Tensor]


def _div(x: torch.Tensor, d) -> torch.Tensor:
    """x / d rounded as IEEE f32 division (optax's): PyTorch's CUDA
    division by a Python number multiplies by its reciprocal instead,
    an ulp apart, which 1 + cos near -1 grows tens of times."""
    return x / torch.full_like(x, float(d))


def polynomial_schedule(init_value: float, end_value: float, power: float,
                        transition_steps: int,
                        transition_begin: int = 0) -> ScheduleFn:
    """optax.polynomial_schedule."""
    if transition_steps <= 0:
        return lambda count: torch.full_like(count, init_value)
    transition_begin = max(transition_begin, 0)

    def schedule(count):
        count = torch.clamp(count - transition_begin, 0, transition_steps)
        frac = 1 - _div(count, transition_steps)
        return (init_value - end_value) * (frac ** power) + end_value
    return schedule


def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float, transition_begin: int = 0,
                      staircase: bool = False) -> ScheduleFn:
    """optax.exponential_decay (without its end_value bound)."""
    if transition_steps <= 0 or decay_rate == 0:
        return lambda count: torch.full_like(count, init_value)
    transition_begin = max(transition_begin, 0)

    def schedule(count):
        decreased_count = count - transition_begin
        p = _div(decreased_count, transition_steps)
        if staircase:
            p = torch.floor(p)
        return torch.where(decreased_count <= 0, init_value,
                           init_value * torch.pow(decay_rate, p))
    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0,
                          exponent: float = 1.0) -> ScheduleFn:
    """optax.cosine_decay_schedule."""
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay_steps}.")

    def schedule(count):
        count = torch.clamp_max(count, float(decay_steps))
        # the f32 angle's cosine rounded once from f64: a correctly
        # rounded f32 cos, as XLA's is; PyTorch's f32 cos can be an ulp
        # off, which 1 + cos near -1 grows to several ulps of the result
        angle = _div(math.pi * count, decay_steps)
        cosine_decay = 0.5 * (1 + torch.cos(angle.double()).float())
        decayed = (1 - alpha) * cosine_decay ** exponent + alpha
        return init_value * decayed
    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0) -> ScheduleFn:
    """optax.warmup_cosine_decay_schedule: a linear warmup joined to a
    cosine decay at `warmup_steps` (optax.join_schedules)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = polynomial_schedule(init_value, peak_value, 1, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                  alpha=alpha, exponent=exponent)

    def schedule(count):
        return torch.where(count < warmup_steps, warm(count),
                           decay(count - warmup_steps))
    return schedule


class Schedule:
    """A learning-rate schedule builder: `build(base_lr)` returns the
    schedule function (f32 count tensor -> f32 lr tensor)."""

    def build(self, base_lr: float) -> ScheduleFn:
        raise NotImplementedError


class Poly(Schedule):
    def __init__(self, power: float, max_iteration: int):
        self.power, self.max_iteration = power, max_iteration

    def build(self, base_lr):
        return polynomial_schedule(base_lr, 0.0, self.power,
                                   self.max_iteration)


class Exponential(Schedule):
    def __init__(self, decay_step: int, decay_rate: float, stair_case=False):
        self.decay_step, self.decay_rate = decay_step, decay_rate
        self.stair_case = stair_case

    def build(self, base_lr):
        return exponential_decay(base_lr, self.decay_step, self.decay_rate,
                                 staircase=self.stair_case)


class Step(Schedule):
    def __init__(self, step_size: int, gamma: float):
        self.step_size, self.gamma = step_size, gamma

    def build(self, base_lr):
        return exponential_decay(base_lr, self.step_size, self.gamma,
                                 staircase=True)


class Warmup(Schedule):
    def __init__(self, warmup_steps: int, total_steps: int,
                 end_value: float = 0.0):
        self.warmup_steps, self.total_steps = warmup_steps, total_steps
        self.end_value = end_value

    def build(self, base_lr):
        return warmup_cosine_decay_schedule(
            0.0, base_lr, self.warmup_steps, self.total_steps,
            end_value=self.end_value)


class LRSchedule:
    """A schedule's state on the device for one built optimizer: `count`
    (f32, the steps taken) and `lr` (0-d f32, the tensor the fused
    optimizer reads).  `before_step` writes fn(count) into `lr`;
    `after_step(taken)` adds the step's taken flag to `count`."""

    def __init__(self, fn: ScheduleFn, device):
        self.fn = fn
        self.count = torch.zeros((), dtype=torch.float32, device=device)
        self.lr = torch.zeros((), dtype=torch.float32, device=device)
        self.before_step()

    def before_step(self) -> None:
        self.lr.copy_(self.fn(self.count))

    def after_step(self, taken: torch.Tensor) -> None:
        self.count.add_(taken)


class OptaxOptimizer(torch.optim.Optimizer):
    """An optax update rule as elementwise torch operations on each
    parameter, skipped on the device: where the engine's `found_inf` (a
    0-d tensor) is nonzero, parameters and state keep their values
    bitwise (`torch.where`, no host read), as the fused torch.optim
    optimizers do.  `lr` is a float or the schedule's 0-d device
    tensor.  Subclasses give `_init(p)` (the state) and `_update(g,
    state, group)` (optax's update before the learning rate, and the
    new state)."""

    def __init__(self, params, defaults):
        super().__init__(params, defaults)
        self.found_inf = None

    def _init(self, p) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def _update(self, g, state, group):
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError(f"{type(self).__name__} takes no closure")
        skip = None if self.found_inf is None else self.found_inf > 0
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state.update(self._init(p))
                scaled, new = self._update(p.grad, state, group)
                # optax: scale by -lr, then apply_updates adds to p
                new["param"] = p + scaled * -group["lr"]
                for key, value in new.items():
                    old = p if key == "param" else state[key]
                    old.copy_(value if skip is None
                              else torch.where(skip, old, value))


class OptaxRMSprop(OptaxOptimizer):
    """optax.rmsprop (no momentum, not centered): ν ← (1 - decay)·g² +
    decay·ν from ν = 0, update g·rsqrt(ν + eps), eps inside the root."""

    def __init__(self, params, lr=1e-3, decay=0.9, eps=1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    def _init(self, p):
        return {"nu": torch.zeros_like(p)}

    def _update(self, g, state, group):
        decay = group["decay"]
        nu = (1 - decay) * (g * g) + decay * state["nu"]
        return torch.rsqrt(nu + group["eps"]) * g, {"nu": nu}


class OptaxAdagrad(OptaxOptimizer):
    """optax.adagrad: the sum of squares starts at
    `initial_accumulator_value`, update g·rsqrt(sum + eps) where the sum
    is positive (0 elsewhere)."""

    def __init__(self, params, lr=1e-2, initial_accumulator_value=0.1,
                 eps=1e-7):
        super().__init__(params, dict(
            lr=lr, initial_accumulator_value=initial_accumulator_value,
            eps=eps))

    def _init(self, p):
        return {"sum_of_squares": torch.full_like(
            p, self.defaults["initial_accumulator_value"])}

    def _update(self, g, state, group):
        acc = g * g + state["sum_of_squares"]
        scale = torch.where(acc > 0, torch.rsqrt(acc + group["eps"]), 0.0)
        return scale * g, {"sum_of_squares": acc}


class OptaxAdadelta(OptaxOptimizer):
    """optax.adadelta (no weight decay): E[g²] ← (1 - ρ)·g² + ρ·E[g²];
    u = sqrt(E[Δx²] + eps) / sqrt(E[g²] + eps)·g; E[Δx²] ← (1 - ρ)·u² +
    ρ·E[Δx²], from u before the learning rate; both start at 0."""

    def __init__(self, params, lr=1.0, rho=0.9, eps=1e-6):
        super().__init__(params, dict(lr=lr, rho=rho, eps=eps))

    def _init(self, p):
        return {"e_g": torch.zeros_like(p), "e_x": torch.zeros_like(p)}

    def _update(self, g, state, group):
        rho, eps = group["rho"], group["eps"]
        e_g = (1 - rho) * (g * g) + rho * state["e_g"]
        u = torch.sqrt(state["e_x"] + eps) / torch.sqrt(e_g + eps) * g
        e_x = (1 - rho) * (u * u) + rho * state["e_x"]
        return u, {"e_g": e_g, "e_x": e_x}


@dataclasses.dataclass
class Optimizer:
    """A torch.optim class and its arguments, plus gradient clipping."""
    cls: type
    kwargs: Dict[str, Any]
    clip_norm: Optional[float] = None
    clip_value: Any = None
    schedule: Optional[Schedule] = None

    def build(self, params):
        """(the torch optimizer, fused where it is torch.optim's, and its
        `LRSchedule` or None).  The optimizer skips the whole update on
        the device where its `found_inf` attribute holds 1; with a
        schedule its lr is the `LRSchedule`'s device tensor."""
        params = list(params)
        kwargs = dict(self.kwargs)
        sched = None
        if self.schedule is not None:
            sched = LRSchedule(self.schedule.build(kwargs["lr"]),
                               params[0].device)
            kwargs["lr"] = sched.lr
        if not issubclass(self.cls, OptaxOptimizer):
            kwargs["fused"] = True
        opt = self.cls(params, **kwargs)
        if self.kwargs.get("momentum"):
            # optax's trace starts at zero; fused SGD would leave a
            # skipped first step an uninitialized momentum buffer
            for p in params:
                opt.state[p]["momentum_buffer"] = torch.zeros_like(p)
        return opt, sched

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


def SGD(learning_rate=1e-2, momentum=0.0, nesterov=False, weight_decay=0.0,
        learningrate_schedule: Optional[Schedule] = None) -> Optimizer:
    return Optimizer(torch.optim.SGD, dict(
        lr=learning_rate, momentum=momentum,
        nesterov=bool(nesterov and momentum), weight_decay=weight_decay),
        schedule=learningrate_schedule)


def Adam(learning_rate=1e-3, beta1=0.9, beta2=0.999, epsilon=1e-8,
         learningrate_schedule: Optional[Schedule] = None) -> Optimizer:
    return Optimizer(torch.optim.Adam, dict(lr=learning_rate,
                                            betas=(beta1, beta2),
                                            eps=epsilon),
                     schedule=learningrate_schedule)


def AdamWeightDecay(learning_rate=1e-3, weight_decay=0.01, beta1=0.9,
                    beta2=0.999, epsilon=1e-6,
                    learningrate_schedule: Optional[Schedule] = None
                    ) -> Optimizer:
    """The BERT optimizer (reference scala keras AdamWeightDecay)."""
    return Optimizer(torch.optim.AdamW, dict(
        lr=learning_rate, betas=(beta1, beta2), eps=epsilon,
        weight_decay=weight_decay), schedule=learningrate_schedule)


def RMSprop(learning_rate=1e-3, decay_rate=0.9, epsilon=1e-8,
            learningrate_schedule: Optional[Schedule] = None) -> Optimizer:
    """optax.rmsprop(learning_rate, decay=decay_rate, eps=epsilon)."""
    return Optimizer(OptaxRMSprop, dict(lr=learning_rate, decay=decay_rate,
                                        eps=epsilon),
                     schedule=learningrate_schedule)


def Adagrad(learning_rate=1e-2,
            learningrate_schedule: Optional[Schedule] = None) -> Optimizer:
    """optax.adagrad(learning_rate)."""
    return Optimizer(OptaxAdagrad, dict(lr=learning_rate),
                     schedule=learningrate_schedule)


def Adadelta(learning_rate=1.0, rho=0.95, epsilon=1e-6,
             learningrate_schedule: Optional[Schedule] = None) -> Optimizer:
    """optax.adadelta(learning_rate, rho=rho, eps=epsilon)."""
    return Optimizer(OptaxAdadelta, dict(lr=learning_rate, rho=rho,
                                         eps=epsilon),
                     schedule=learningrate_schedule)


_REGISTRY = {"sgd": SGD, "adam": Adam, "adamw": AdamWeightDecay,
             "adamweightdecay": AdamWeightDecay, "rmsprop": RMSprop,
             "adagrad": Adagrad, "adadelta": Adadelta}


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
