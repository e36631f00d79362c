"""Checkpoint triggers (a copy of analytics_zoo_tpu/orca/learn/
trigger.py)."""

from __future__ import annotations


class Trigger:
    def __call__(self, *, epoch: int, step: int, epoch_end: bool) -> bool:
        raise NotImplementedError

    @staticmethod
    def resolve(t):
        if t is None or isinstance(t, Trigger):
            return t
        raise TypeError(f"not a Trigger: {t!r}")


class EveryEpoch(Trigger):
    """Fires at each epoch boundary."""

    def __call__(self, *, epoch, step, epoch_end):
        return epoch_end


class SeveralIteration(Trigger):
    """Fires every `interval` training steps."""

    def __init__(self, interval: int):
        if interval <= 0:
            raise ValueError("interval must be positive")
        self.interval = interval

    def __call__(self, *, epoch, step, epoch_end):
        return (not epoch_end) and step > 0 and step % self.interval == 0


class MaxIteration(Trigger):
    """Fires once, when `max_steps` is reached."""

    def __init__(self, max_steps: int):
        self.max = max_steps
        self._fired = False

    def __call__(self, *, epoch, step, epoch_end):
        if self._fired or epoch_end:
            return False
        if step >= self.max:
            self._fired = True
            return True
        return False


class MinLoss(Trigger):
    """Fires while the last epoch's loss (`last_loss`, set by the
    Estimator after each epoch) is below `min_loss`."""

    def __init__(self, min_loss: float):
        self.min = min_loss
        self.last_loss = None

    def __call__(self, *, epoch, step, epoch_end):
        return self.last_loss is not None and self.last_loss < self.min
