"""Per-op serving timers (a copy of analytics_zoo_tpu/serving/timer.py;
reference `serving/engine/Timer.scala:26-100` and the
`Supportive.timing` wrapper).

`Timer` is a thin adapter over `observability.MetricsRegistry`
histograms: `timing` / `record` / `summary` / `print`, nearest-rank
percentiles, the data in registry `Histogram`s so a server's per-op
timers are Prometheus-exposable from the same store.  A bare `Timer()`
gets a private registry; `ServingServer` passes its per-server registry
plus a `serving_` exposition prefix.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Optional

from analytics_zoo_tpu_torch.observability.registry import (
    MetricsRegistry,
    now,
    sanitize_metric_name,
)


class Timer:
    """Thread-safe accumulators + bounded sample reservoirs per op,
    backed by the shared metrics registry.

    registry: the `MetricsRegistry` to record into; None builds a
        private one (drop-in legacy behavior).
    prefix / suffix: exposition naming — op "predict" becomes registry
        histogram `<prefix>predict<suffix>` (ServingServer uses
        prefix="serving_", suffix="_seconds" so /metrics shows
        `serving_predict_seconds` quantiles).  `summary()` keys remain
        the bare op names.
    """

    def __init__(self, reservoir: int = 1024,
                 registry: Optional[MetricsRegistry] = None,
                 prefix: str = "", suffix: str = "_seconds"):
        self._registry = registry or MetricsRegistry(reservoir=reservoir)
        self._reservoir = reservoir
        self._prefix = prefix
        self._suffix = suffix
        #: op name -> Histogram, for the ops THIS timer recorded (a
        #: shared registry may hold other subsystems' metrics too)
        self._ops: Dict[str, "object"] = {}

    @property
    def registry(self) -> MetricsRegistry:
        return self._registry

    def _histogram(self, name: str):
        h = self._ops.get(name)
        if h is None:
            h = self._registry.histogram(
                self._prefix + sanitize_metric_name(name) + self._suffix,
                help=f"per-op serving timer: {name}",
                reservoir=self._reservoir)
            self._ops[name] = h
        return h

    @contextmanager
    def timing(self, name: str, count: int = 1):
        """`with timer.timing("predict", n_records): ...` — the
        Supportive.timing analog."""
        t0 = now()
        try:
            yield
        finally:
            self.record(name, now() - t0, count)

    def record(self, name: str, seconds: float, count: int = 1):
        self._histogram(name).record(seconds, count)

    def summary(self) -> Dict[str, Dict]:
        """{op: {calls, records, total_ms, avg_ms, p50_ms, p90_ms,
        p99_ms, max_ms, records_per_s}} — the Timer.print histogram as
        data, ops in stable (sorted) order."""
        return {name: self._ops[name].summary_row()
                for name in sorted(self._ops)}

    def print(self):  # reference Timer.print
        for name, row in self.summary().items():
            print(f"[timer] {name}: {row}")
