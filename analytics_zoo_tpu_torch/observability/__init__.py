"""Observability of the port (counterpart of analytics_zoo_tpu/
observability/): the training-side and serving-side planes, under JAX's
names.

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
* the serving side: SLO tracking (slo.py), latency blame (blame.py)
  and tail exemplars (exemplars.py) fed by the request log, W3C trace
  context (trace_context.py), the Chrome-trace timeline export
  (timeline.py), the metrics history with its alert engine
  (history.py, alerts.py), the telemetry spool (telemetry_spool.py)
  and the fleet view over the local process and the spooled snapshots
  (fleet.py).

`Estimator.fit` and the `TrainEngine`, the generation engine and its
scheduler, the resilience hooks and the serving front end call them
where JAX's do.

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
    blame,
    exemplars,
    flight_recorder,
    history,
    memory,
    profiling,
    request_log,
    telemetry_spool,
    timeline,
    trace_context,
)
from analytics_zoo_tpu_torch.observability.blame import (  # noqa: F401
    BlameTracker,
    PHASES,
    blame_payload,
    get_blame_tracker,
    phase_ledger,
    reset_blame_tracker,
)
from analytics_zoo_tpu_torch.observability.exemplars import (  # noqa: F401
    ExemplarStore,
    get_exemplar_store,
    reset_exemplar_store,
)
from analytics_zoo_tpu_torch.observability.alerts import (  # noqa: F401
    AlertEngine,
    AlertRule,
    BUILTIN_ALERTS,
    builtin_rules,
)
from analytics_zoo_tpu_torch.observability.history import (  # noqa: F401
    HistoryReader,
    MetricsRecorder,
    SampleLog,
    get_recorder,
    maybe_record,
    reset_recorder,
)
from analytics_zoo_tpu_torch.observability.fleet import (  # noqa: F401
    FleetAggregator,
    labeled_prometheus_text,
)
from analytics_zoo_tpu_torch.observability.telemetry_spool import (  # noqa: F401,E501
    TelemetrySpool,
    maybe_spool,
)
from analytics_zoo_tpu_torch.observability.trace_context import (  # noqa: F401,E501
    TraceContext,
    current_trace_context,
    parse_traceparent,
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
from analytics_zoo_tpu_torch.observability.slo import (  # noqa: F401
    SLOTracker,
    get_shadow_slo_tracker,
    get_slo_tracker,
    reset_slo_tracker,
)
from analytics_zoo_tpu_torch.observability.timeline import (  # noqa: F401
    export_timeline,
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
#: tensors (JAX sums `jax.live_arrays()`) and its series on the
#: timeline's memory track, and the flight bundle's framework section.
RENAMED_FROM_JAX = {
    "jax_jit_compile_seconds": "torch_first_dispatch_seconds",
    "memory_jax_live_buffer_bytes": "memory_device_allocated_bytes",
    "jax_live_buffers": "device_allocated",
    "jax": "torch",
}

__all__ = [
    "AlertEngine", "AlertRule", "BUILTIN_ALERTS", "BlameTracker",
    "CausalLMFlops", "Counter", "DISPATCH_FAMILIES", "ExemplarStore",
    "FleetAggregator", "Gauge", "Histogram", "HistoryReader",
    "MetricsRecorder", "MetricsRegistry", "PHASES", "RENAMED_FROM_JAX",
    "RequestLog", "SLOTracker", "SampleLog", "Span", "StepClock",
    "TelemetrySpool", "TraceContext", "Watchdog", "annotate", "blame",
    "blame_payload", "builtin_rules", "clear_spans", "close_sink",
    "compile_events", "current_span", "current_trace_context",
    "diff_signatures", "exemplars", "export_timeline",
    "flight_recorder", "get_blame_tracker", "get_exemplar_store",
    "get_recorder", "get_registry", "get_request_log",
    "get_shadow_slo_tracker", "get_slo_tracker", "goodput_tables",
    "history", "instrument", "labeled_prometheus_text",
    "ledger_snapshot", "localize_nonfinite", "log_event", "maybe_record",
    "maybe_spool", "maybe_watchdog", "memory", "merged_prometheus_text",
    "nearest_rank", "new_request_id", "nonfinite_leaves", "now",
    "parse_prometheus_text", "parse_traceparent", "phase_ledger",
    "process_goodput_ratio", "profiling", "recent_spans", "record_work",
    "request_log", "reset_blame_tracker", "reset_exemplar_store",
    "reset_profiling", "reset_recorder", "reset_registry",
    "reset_request_log", "reset_slo_tracker", "sanitize_metric_name",
    "step_clock", "telemetry_spool", "timeline", "trace",
    "trace_context", "train_step_flops",
]
