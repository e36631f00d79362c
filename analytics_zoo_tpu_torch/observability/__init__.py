"""Observability of the port (counterpart of analytics_zoo_tpu/observability/):
so far the metrics registry alone, which the serving front end's timers
and `GET /metrics` read.  Spans, events, the request lifecycle log and
the other planes are not ported yet."""

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

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "merged_prometheus_text", "nearest_rank", "now",
           "parse_prometheus_text", "reset_registry",
           "sanitize_metric_name"]
