"""Process-global metrics substrate (a copy of
analytics_zoo_tpu/observability/registry.py, the one observability
module the port has so far).

One thread-safe `MetricsRegistry`: counters, gauges (including
callback gauges for live values like queue depth) and histograms with
bounded reservoirs, all exposable as Prometheus text-format (the
pull-based exposition model) and as plain dicts for JSON endpoints.
The serving front end's per-op timers (`serving/timer.py`) and its
`GET /metrics` read it; the text is byte for byte the JAX package's for
the same operations.
"""

from __future__ import annotations

import math
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

#: The one process clock for all observability timing, so a future
#: monotonic-clock swap is one line.
now = time.perf_counter

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_metric_name(name: str) -> str:
    """Prometheus metric names are [a-zA-Z_:][a-zA-Z0-9_:]*."""
    name = _NAME_RE.sub("_", name)
    if not name or name[0].isdigit():
        name = "_" + name
    return name


def nearest_rank(sorted_samples: List[float], p: float) -> float:
    """Nearest-rank percentile: ceil(p*n) - 1 (int(p*n) is one rank
    high — p90 of 10 samples would be the max).  0.0 on empty input."""
    n = len(sorted_samples)
    if n == 0:
        return 0.0
    return sorted_samples[min(n - 1, max(0, math.ceil(p * n) - 1))]


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("name", "help", "_lock", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value; either set/inc/dec'd, or backed by a
    callback (`fn`) sampled at read time — how live values like batcher
    queue depth and worker-pool utilization are exposed without a
    background sampler thread.

    Written (set/inc/dec) gauges additionally track the min/max value
    ever observed (`.min`/`.max`) — what the goodput breakdown tables
    use to report best/worst step wall time without a histogram's
    reservoir cost.  Callback gauges report nan extremes (their reads
    are not observed by this object)."""

    __slots__ = ("name", "help", "fn", "_lock", "_value", "_min",
                 "_max")

    def __init__(self, name: str, help: str = "",
                 fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.help = help
        self.fn = fn
        self._lock = threading.Lock()
        self._value = 0.0
        self._min = math.inf
        self._max = -math.inf

    def _observe_locked(self) -> None:
        if self._value < self._min:
            self._min = self._value
        if self._value > self._max:
            self._max = self._value

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)
            self._observe_locked()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n
            self._observe_locked()

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def min(self) -> float:
        """Smallest value ever written (nan before any write)."""
        with self._lock:
            return self._min if self._min != math.inf else float("nan")

    @property
    def max(self) -> float:
        """Largest value ever written (nan before any write)."""
        with self._lock:
            return self._max if self._max != -math.inf else \
                float("nan")

    @property
    def value(self) -> float:
        if self.fn is not None:
            try:
                return float(self.fn())
            except Exception:
                # a dying callback must never take /metrics down with it
                return float("nan")
        with self._lock:
            return self._value


class Histogram:
    """Accumulators + a bounded sample reservoir (newest-kept), the
    `Timer.scala` accumulator generalized.  `record` takes a duration
    (or any value) plus an optional weight (`count` = records this
    observation covered), so records/s decompositions fall out."""

    __slots__ = ("name", "help", "_lock", "_reservoir", "calls",
                 "records", "total", "max", "_samples")

    def __init__(self, name: str, help: str = "", reservoir: int = 1024):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._reservoir = reservoir
        self.calls = 0
        self.records = 0
        self.total = 0.0
        self.max = 0.0
        self._samples: List[float] = []

    def record(self, value: float, count: int = 1) -> None:
        with self._lock:
            self.calls += 1
            self.records += count
            self.total += value
            if value > self.max:
                self.max = value
            s = self._samples
            s.append(value)
            if len(s) > self._reservoir:
                del s[: len(s) - self._reservoir]

    def time(self):
        """Context manager recording the wall time of the block."""
        return _HistogramTimer(self)

    def _snap(self) -> Tuple[int, int, float, float, List[float]]:
        """Consistent copy of the accumulators; sorting and percentile
        math happen OUTSIDE the lock."""
        with self._lock:
            return (self.calls, self.records, self.total, self.max,
                    list(self._samples))

    def quantile(self, p: float) -> float:
        return nearest_rank(sorted(self._snap()[4]), p)

    def summary_row(self) -> Dict[str, float]:
        """The serving-Timer row: {calls, records, total_ms, avg_ms,
        p50_ms, p90_ms, p99_ms, max_ms, records_per_s}."""
        calls, records, total, mx, samples = self._snap()
        samples.sort()
        return {
            "calls": calls,
            "records": records,
            "total_ms": round(total * 1e3, 3),
            "avg_ms": round(total / max(calls, 1) * 1e3, 3),
            "p50_ms": round(nearest_rank(samples, 0.50) * 1e3, 3),
            "p90_ms": round(nearest_rank(samples, 0.90) * 1e3, 3),
            "p99_ms": round(nearest_rank(samples, 0.99) * 1e3, 3),
            "max_ms": round(mx * 1e3, 3),
            "records_per_s": round(records / total, 1)
            if total > 0 else 0.0,
        }


class _HistogramTimer:
    __slots__ = ("_h", "_t0")

    def __init__(self, h: Histogram):
        self._h = h

    def __enter__(self):
        self._t0 = now()
        return self

    def __exit__(self, *exc):
        # record in __exit__ UNCONDITIONALLY: a raising body must still
        # contribute its elapsed time (a goodput table that silently
        # dropped every failing step would overstate health) — the
        # exception itself propagates untouched
        self._h.record(now() - self._t0)
        return False


_QUANTILES = (0.5, 0.9, 0.99)


class MetricsRegistry:
    """Get-or-create metric registry; all accessors are thread-safe
    and idempotent (same name → same instance; a name re-used with a
    different metric type raises)."""

    def __init__(self, reservoir: int = 1024):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}
        self._reservoir = reservoir

    def _get(self, name: str, cls, factory):
        name = sanitize_metric_name(name)
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory(name)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, lambda n: Counter(n, help))

    def gauge(self, name: str, help: str = "",
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        g = self._get(name, Gauge, lambda n: Gauge(n, help, fn))
        if fn is not None:
            g.fn = fn
        return g

    def histogram(self, name: str, help: str = "",
                  reservoir: Optional[int] = None) -> Histogram:
        r = self._reservoir if reservoir is None else reservoir
        return self._get(name, Histogram,
                         lambda n: Histogram(n, help, reservoir=r))

    def metrics(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._metrics)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-friendly dump: counters/gauges as numbers, histograms
        as their summary rows.  Stable (sorted) key order."""
        out: Dict[str, Any] = {}
        for name in sorted(self.metrics()):
            m = self.metrics()[name]
            if isinstance(m, Histogram):
                out[name] = m.summary_row()
            else:
                out[name] = m.value
        return out

    def sample_values(
            self, families: Optional[Tuple[str, ...]] = None,
    ) -> Dict[str, Dict[str, float]]:
        """One flat numeric snapshot for the metrics history recorder
        (observability/history.py): ``{"counters": {name: v},
        "gauges": {name: v}}``.  Histograms contribute their cumulative
        ``<name>_sum`` / ``<name>_count`` accumulators as counters
        (what a rate over time needs; reservoir quantiles are a
        point-in-time artifact and stay out of history).  Callback
        gauges are sampled; a non-finite gauge read is skipped rather
        than recorded (NaN poisons every derived series downstream).
        `families` is an optional tuple of name prefixes to keep."""
        def keep(name: str) -> bool:
            return families is None or any(
                name.startswith(f) for f in families)

        counters: Dict[str, float] = {}
        gauges: Dict[str, float] = {}
        for name, m in self.metrics().items():
            if not keep(name):
                continue
            if isinstance(m, Counter):
                counters[name] = m.value
            elif isinstance(m, Gauge):
                v = m.value
                if math.isfinite(v):
                    gauges[name] = v
            else:
                calls, _records, total, _mx, _s = m._snap()
                counters[name + "_sum"] = total
                counters[name + "_count"] = float(calls)
        return {"counters": counters, "gauges": gauges}

    def prometheus_text(self) -> str:
        """Prometheus text exposition format.  Histograms are emitted
        as `summary` metrics (quantile labels + _sum/_count, plus a
        non-standard `<name>_max`); stable name order."""
        lines: List[str] = []
        metrics = self.metrics()
        for name in sorted(metrics):
            m = metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {m.value:g}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {m.value:g}")
            else:
                calls, records, total, mx, samples = m._snap()
                samples.sort()
                lines.append(f"# TYPE {name} summary")
                for q in _QUANTILES:
                    v = nearest_rank(samples, q)
                    lines.append(f'{name}{{quantile="{q:g}"}} {v:g}')
                lines.append(f"{name}_sum {total:g}")
                lines.append(f"{name}_count {calls:g}")
                lines.append(f"{name}_max {mx:g}")
                if records != calls:
                    lines.append(f"{name}_records {records:g}")
        return "\n".join(lines) + ("\n" if lines else "")


def merged_prometheus_text(*registries: MetricsRegistry) -> str:
    """Concatenate several registries' expositions (first wins on a
    name collision) — how a per-server registry and the process-global
    one share a single /metrics endpoint."""
    seen: set = set()
    parts: List[str] = []
    for reg in registries:
        names = set(reg.metrics())
        if names & seen:
            # re-emit only the non-colliding metrics of this registry
            sub = MetricsRegistry()
            with sub._lock:
                sub._metrics = {n: m for n, m in reg.metrics().items()
                                if n not in seen}
            parts.append(sub.prometheus_text())
            seen |= names
        else:
            parts.append(reg.prometheus_text())
            seen |= names
    return "".join(parts)


def parse_prometheus_text(text: str) -> Dict[str, Dict[str, Any]]:
    """Minimal parser for the exposition this module writes (what
    bench.py uses to consume a live server's /metrics).  Returns
    {name: {"type": str, "value": float, "sum": float, "count": float,
    "max": float, "quantiles": {q: v}}} with only the fields present.
    """
    out: Dict[str, Dict[str, Any]] = {}
    cur_type: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                cur_type[parts[2]] = parts[3]
            continue
        try:
            key, val_s = line.rsplit(None, 1)
            val = float(val_s)
        except ValueError:
            continue
        name, labels = key, ""
        if "{" in key:
            name, labels = key[:key.index("{")], key[
                key.index("{") + 1:key.rindex("}")]
        base = name
        field = "value"
        for suffix in ("_sum", "_count", "_max", "_records"):
            if name.endswith(suffix) and name[:-len(suffix)] in cur_type:
                base, field = name[:-len(suffix)], suffix[1:]
                break
        entry = out.setdefault(base, {"type": cur_type.get(base, "")})
        m = re.search(r'quantile="([^"]+)"', labels)
        if m:
            entry.setdefault("quantiles", {})[float(m.group(1))] = val
        else:
            entry[field] = val
    return out


#: The process-global registry (the tentpole).  Subsystems that need
#: isolation (a ServingServer's per-op timers, tests) build their own
#: MetricsRegistry and merge it at exposition time.
_GLOBAL = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _GLOBAL


def reset_registry() -> MetricsRegistry:
    """Swap in a fresh global registry (tests)."""
    global _GLOBAL
    _GLOBAL = MetricsRegistry()
    return _GLOBAL
