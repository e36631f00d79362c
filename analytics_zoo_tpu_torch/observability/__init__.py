"""Observability of the port (counterpart of analytics_zoo_tpu/
observability/): the training-side planes, under JAX's names.

* `get_registry()` — the process-global `MetricsRegistry` (counters,
  gauges, bounded-reservoir histograms), exposable as Prometheus text.
* `trace(name, **attrs)` — contextvar-propagated spans; completed ones
  are readable through `recent_spans`.
* `log_event(kind, **fields)` — countable structured events, appended
  as JSONL under `OrcaContext.observability_dir` when set.
* goodput step accounting (`step_clock`, goodput.py), the flight
  recorder and watchdogs (flight_recorder.py, watchdog.py), memory
  telemetry (memory.py), the dispatch ledger with MFU (profiling.py) and
  the per-request lifecycle log (request_log.py).

`Estimator.fit` and the `TrainEngine`, the generation engine and its
scheduler, and the resilience hooks call them where JAX's do.  Still to
come (ROADMAP item 6b): SLO tracking, the timeline export, latency
blame, exemplars, trace context, alerts, the metrics history, the
telemetry spool, the fleet view and the server routes that serve them.

`now` is the one clock for instrumentation (the monotonic performance
counter, defined once in registry.py).

Every span, event, metric, ledger family and bundle key keeps JAX's
name, except the three that name JAX (`RENAMED_FROM_JAX`).
"""

from analytics_zoo_tpu_torch.observability.registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    merged_prometheus_text,
    nearest_rank,
    now,
    parse_prometheus_text,
    reset_registry,
    sanitize_metric_name,
)
from analytics_zoo_tpu_torch.observability.tracing import (  # noqa: F401
    Span,
    annotate,
    clear_spans,
    current_span,
    recent_spans,
    trace,
)
from analytics_zoo_tpu_torch.observability.events import (  # noqa: F401
    close_sink,
    log_event,
)
from analytics_zoo_tpu_torch.observability.goodput import (  # noqa: F401
    StepClock,
    goodput_tables,
    process_goodput_ratio,
    step_clock,
)
from analytics_zoo_tpu_torch.observability import (  # noqa: F401
    flight_recorder,
    memory,
    profiling,
    request_log,
)
from analytics_zoo_tpu_torch.observability.request_log import (  # noqa: F401
    RequestLog,
    get_request_log,
    new_request_id,
    reset_request_log,
)
from analytics_zoo_tpu_torch.observability.profiling import (  # noqa: F401
    CausalLMFlops,
    DISPATCH_FAMILIES,
    compile_events,
    diff_signatures,
    instrument,
    ledger_snapshot,
    record_work,
    reset_profiling,
    train_step_flops,
)
from analytics_zoo_tpu_torch.observability.watchdog import (  # noqa: F401
    Watchdog,
    localize_nonfinite,
    maybe_watchdog,
    nonfinite_leaves,
)

#: The names of JAX's planes that name JAX, and the port's name for
#: each: the first-dispatch histogram of the train engine's step spans
#: (JAX times XLA's compile there), the memory gauge of the card's live
#: tensors (JAX sums `jax.live_arrays()`), and the flight bundle's
#: framework section.
RENAMED_FROM_JAX = {
    "jax_jit_compile_seconds": "torch_first_dispatch_seconds",
    "memory_jax_live_buffer_bytes": "memory_device_allocated_bytes",
    "jax": "torch",
}

__all__ = [
    "CausalLMFlops", "Counter", "DISPATCH_FAMILIES", "Gauge", "Histogram",
    "MetricsRegistry", "RENAMED_FROM_JAX", "RequestLog", "Span",
    "StepClock", "Watchdog", "annotate", "clear_spans", "close_sink",
    "compile_events", "current_span", "diff_signatures",
    "flight_recorder", "get_registry", "get_request_log",
    "goodput_tables", "instrument", "ledger_snapshot",
    "localize_nonfinite", "log_event", "maybe_watchdog", "memory",
    "merged_prometheus_text", "nearest_rank", "new_request_id",
    "nonfinite_leaves", "now", "parse_prometheus_text",
    "process_goodput_ratio", "profiling", "recent_spans", "record_work",
    "request_log", "reset_profiling", "reset_registry",
    "reset_request_log", "sanitize_metric_name", "step_clock", "trace",
    "train_step_flops",
]
