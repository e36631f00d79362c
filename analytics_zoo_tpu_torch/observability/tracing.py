"""Span tracing (a copy of analytics_zoo_tpu/observability/tracing.py):
Dapper-style parent/child spans with contextvar propagation, in one
process.

`trace(name, **attrs)` opens a span; nested `trace` calls (same thread
or same asyncio task) take the enclosing span as parent through a
contextvar.  A hop across an explicit thread or queue boundary passes
`current_span()` captured on the submitting side as `trace(...,
parent=span)` on the executing side: contextvars do not flow into
threads that already exist.

Completed spans land in a bounded in-process ring (`recent_spans`), are
recorded as a duration histogram `span_<name>_seconds` in the global
`MetricsRegistry`, and are appended to the JSONL event sink when
`OrcaContext.observability_dir` is set.  A span with no local parent
takes the ambient remote parent (`trace_context.bind`, or the
TRACEPARENT environment variable): a W3C traceparent from another
process.
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Any, Dict, List, Optional

from analytics_zoo_tpu_torch.observability.registry import (
    get_registry,
    now,
    sanitize_metric_name,
)

_CURRENT: "ContextVar[Optional[Span]]" = ContextVar(
    "azt_torch_current_span", default=None)

_MAX_SPANS = 2048
_ring_lock = threading.Lock()
_ring: "deque[Dict[str, Any]]" = deque(maxlen=_MAX_SPANS)


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


class Span:
    """One timed operation.  Mutable while open (attrs through
    `annotate`); snapshotted into the ring when it closes."""

    __slots__ = ("name", "span_id", "parent_id", "trace_id", "attrs",
                 "thread", "start_ts", "_t0", "duration_s", "error")

    def __init__(self, name: str, parent: Optional["Span"] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self.span_id = _new_id()
        self.parent_id = parent.span_id if parent is not None else None
        self.trace_id = (parent.trace_id if parent is not None
                         else self.span_id)
        self.attrs = dict(attrs or {})
        self.thread = threading.current_thread().name
        self.start_ts = time.time()   # wall clock, for humans and logs
        self._t0 = now()              # monotonic, for the duration
        self.duration_s: Optional[float] = None
        self.error: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        d = {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "trace_id": self.trace_id,
            "thread": self.thread,
            "start_ts": round(self.start_ts, 6),
            "duration_s": (round(self.duration_s, 9)
                           if self.duration_s is not None else None),
            "attrs": dict(self.attrs),
        }
        if self.error:
            d["error"] = self.error
        return d


def current_span() -> Optional[Span]:
    """The innermost open span of this thread or context (None outside
    any `trace` block)."""
    return _CURRENT.get()


def annotate(**attrs) -> None:
    """Attach attributes to the current open span (no-op outside one)."""
    span = _CURRENT.get()
    if span is not None:
        span.attrs.update(attrs)


_MISSING = object()


@contextmanager
def trace(name: str, parent: Any = _MISSING, record_metric: bool = True,
          **attrs):
    """Open a span for the enclosed block.

    parent: defaults to `current_span()`; pass an explicit Span (or
        None for a fresh root) when crossing a thread or queue boundary.
        Anything with `.span_id` and `.trace_id` works, notably a
        `trace_context.TraceContext` received from another process.
        With no local span open, the ambient remote parent bound by
        `trace_context.bind` (or the TRACEPARENT environment variable)
        is used, so the first span after a cross-process hop joins the
        caller's trace.
    record_metric: also record the duration into the global histogram
        `span_<name>_seconds` (default on).
    Other keywords become span attributes.
    """
    p = current_span() if parent is _MISSING else parent
    if p is None and parent is _MISSING:
        # trace_context imports this module: imported at call time
        from analytics_zoo_tpu_torch.observability import trace_context
        p = trace_context.remote_parent()
    span = Span(name, parent=p, attrs=attrs)
    token = _CURRENT.set(span)
    try:
        yield span
    except BaseException as e:
        span.error = f"{type(e).__name__}: {e}"
        raise
    finally:
        _CURRENT.reset(token)
        span.duration_s = now() - span._t0
        _finish(span, record_metric)


def _finish(span: Span, record_metric: bool) -> None:
    with _ring_lock:
        _ring.append(span.to_dict())
    if record_metric:
        get_registry().histogram(
            "span_" + sanitize_metric_name(span.name) + "_seconds",
            help=f"wall time of {span.name} spans").record(
            span.duration_s)
    # events imports this module's ring helpers: imported at call time
    from analytics_zoo_tpu_torch.observability.events import (
        log_event,
        sink_enabled,
    )
    if sink_enabled():
        log_event("span", _count_metric=False, **span.to_dict())


def recent_spans(n: int = 100) -> List[Dict[str, Any]]:
    """The most recent `n` completed spans, newest first."""
    with _ring_lock:
        items = list(_ring)
    return list(reversed(items[-max(0, int(n)):]))


def clear_spans() -> None:
    """Drop the completed-span ring (tests)."""
    with _ring_lock:
        _ring.clear()
