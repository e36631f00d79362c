"""Typed retry policy (a copy of analytics_zoo_tpu/resilience/retry.py):
max attempts, deterministic exponential backoff and an optional
wall-clock deadline.  Each attempt of `run` is a ``retry.attempt``
span, linked to the attempt it retries; each retry decision ticks
``resilience_retries_total`` and logs a ``retry`` event.

Backoff is unjittered by default; ``jitter="full"`` scales it by a
uniform draw from a PRNG seeded by ``(seed, attempt)``, so any one
policy's schedule is a pure function of its fields.  `Estimator.fit`'s
restore-and-resume loop and the checkpoint I/O use it.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Optional, Tuple, Type


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with deterministic exponential backoff.

    `backoff(attempt)` (attempt is 1-based) returns
    ``backoff_s * multiplier**(attempt-1)`` capped at `max_backoff_s`;
    with ``jitter="full"`` that value is scaled by a uniform draw from
    a PRNG seeded by ``(seed, attempt)``.  `run(fn)` applies the
    policy, re-raising the last retryable error once `max_attempts` or
    `deadline_s` is exhausted.  Non-retryable exceptions propagate
    immediately."""

    max_attempts: int = 3
    backoff_s: float = 0.1
    multiplier: float = 2.0
    max_backoff_s: float = 30.0
    deadline_s: Optional[float] = None
    name: str = ""
    jitter: str = "none"
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.backoff_s < 0 or self.multiplier < 1:
            raise ValueError(
                "backoff_s must be >= 0 and multiplier >= 1")
        if self.jitter not in ("none", "full"):
            raise ValueError("jitter must be 'none' or 'full'")

    def _draw(self, attempt: int, salt: int) -> float:
        # plain integer arithmetic for the seed: stable across
        # processes and PYTHONHASHSEED values
        return random.Random(
            self.seed * 1_000_003 + salt * 8191 + attempt).random()

    def backoff(self, attempt: int) -> float:
        """Delay before retry number `attempt` (1-based); with full
        jitter, uniform over [0, the exponential backoff]."""
        base = min(self.backoff_s * self.multiplier ** (attempt - 1),
                   self.max_backoff_s)
        if self.jitter == "full":
            return base * self._draw(attempt, 1)
        return base

    def spread(self, delay_s: float, attempt: int) -> float:
        """A server's hint (Retry-After) bounded by `max_backoff_s`; with
        full jitter, uniform over [0.5x, 1.5x] of the hint."""
        delay = min(float(delay_s), self.max_backoff_s)
        if self.jitter == "full":
            delay = min(delay * (0.5 + self._draw(attempt, 2)),
                        self.max_backoff_s)
        return delay

    def delays(self) -> Tuple[float, ...]:
        """The whole backoff schedule, one entry per possible retry."""
        return tuple(self.backoff(i)
                     for i in range(1, self.max_attempts))

    def run(self, fn: Callable, *,
            retryable: Tuple[Type[BaseException], ...] = (Exception,),
            on_retry: Optional[Callable] = None,
            sleep: Callable[[float], None] = time.sleep):
        """Call `fn()` under the policy.  `on_retry(attempt, exc,
        delay)` observes each retry decision; `sleep` is injectable for
        tests.  The deadline covers sleeps and the next attempt's start
        (elapsed + pending delay past `deadline_s` stops retrying).

        Each attempt runs in a ``retry.attempt`` span tagged with the
        attempt number and linked (`prev_span_id`) to the attempt it
        retries, so all attempts read as one trace."""
        start = time.monotonic()
        prev_span_id: Optional[str] = None
        for attempt in range(1, self.max_attempts + 1):
            try:
                with self._attempt_span(attempt, prev_span_id) as sp:
                    return fn()
            except retryable as e:
                prev_span_id = getattr(sp, "span_id", None)
                if attempt >= self.max_attempts:
                    raise
                delay = self.backoff(attempt)
                if self.deadline_s is not None and \
                        time.monotonic() - start + delay > self.deadline_s:
                    raise
                self.record_retry(e)
                if on_retry is not None:
                    on_retry(attempt, e, delay)
                if delay > 0:
                    sleep(delay)

    def _attempt_span(self, attempt: int,
                      prev_span_id: Optional[str]):
        """A trace span for one attempt."""
        from analytics_zoo_tpu_torch.observability import trace
        attrs = {"policy": self.name or "anonymous",
                 "attempt": attempt}
        if prev_span_id is not None:
            attrs["prev_span_id"] = prev_span_id
        return trace("retry.attempt", **attrs)

    def record_retry(self, exc: BaseException) -> None:
        """Count and log one retry decision (also used by callers that
        keep their own loop, as the Estimator's restore-and-resume cycle
        does)."""
        from analytics_zoo_tpu_torch.observability import (
            get_registry,
            log_event,
        )
        get_registry().counter(
            "resilience_retries_total",
            help="retries taken under a RetryPolicy "
                 "(resilience/retry.py)").inc()
        log_event("retry", policy=self.name or "anonymous",
                  error=f"{type(exc).__name__}: {exc}")
