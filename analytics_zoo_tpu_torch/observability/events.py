"""Structured event log (a copy of analytics_zoo_tpu/observability/
events.py): countable, machine-readable events instead of prints.

`log_event(kind, **fields)` always increments the global counters
`events_total` and `events_<kind>_total` (so an event stays countable
through `/metrics` with no sink configured), and, when
`OrcaContext.observability_dir` is set, appends one JSON line to
`<dir>/events.jsonl`.  Sink failures are swallowed: observability must
never take the observed path down.  Field values are made JSON-safe
(`_jsonable`): numpy scalars and 0-d torch tensors become plain
numbers, anything else unknown its `str`.
"""

from __future__ import annotations

import json
import numbers
import os
import threading
import time
from typing import Any, Optional, TextIO

import torch

from analytics_zoo_tpu_torch.observability.registry import (
    get_registry,
    sanitize_metric_name,
)

_lock = threading.Lock()
_sink: Optional[TextIO] = None
_sink_dir: Optional[str] = None

EVENTS_FILENAME = "events.jsonl"


def _configured_dir() -> Optional[str]:
    from analytics_zoo_tpu_torch.common.context import OrcaContext
    return OrcaContext.observability_dir


def sink_enabled() -> bool:
    return _configured_dir() is not None


def _get_sink(directory: str) -> Optional[TextIO]:
    """(Re)open the JSONL sink when the configured dir changes."""
    global _sink, _sink_dir
    if _sink is not None and _sink_dir == directory:
        return _sink
    if _sink is not None:
        try:
            _sink.close()
        except Exception:
            pass
        _sink = None
    try:
        os.makedirs(directory, exist_ok=True)
        _sink = open(os.path.join(directory, EVENTS_FILENAME), "a",
                     encoding="utf-8")
        _sink_dir = directory
    except OSError:
        _sink, _sink_dir = None, None
    return _sink


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    # a 0-d tensor (an epoch stat left on the device) is read here, on
    # the cold path that logs it
    if isinstance(v, torch.Tensor) and v.dim() == 0:
        return _jsonable(v.item())
    # numpy scalars (epoch stats, span attrs) become plain numbers
    if isinstance(v, numbers.Integral):
        return int(v)
    if isinstance(v, numbers.Real):
        return float(v)
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return str(v)


def log_event(kind: str, _count_metric: bool = True, **fields) -> None:
    """Emit one structured event.  Never raises."""
    try:
        if _count_metric:
            reg = get_registry()
            reg.counter("events_total",
                        help="structured events emitted").inc()
            reg.counter(
                "events_" + sanitize_metric_name(kind) + "_total",
                help=f"{kind} events emitted").inc()
        if kind != "span":
            # events also land in the flight-recorder ring, so a bundle
            # carries the recent history with no JSONL sink configured
            # (spans have their own ring, tracing.py)
            from analytics_zoo_tpu_torch.observability import (
                flight_recorder,
            )
            flight_recorder.record(
                "event:" + kind,
                **{k: _jsonable(v) for k, v in fields.items()})
        directory = _configured_dir()
        if directory is None:
            return
        record = {"ts": round(time.time(), 6), "kind": kind}
        record.update({k: _jsonable(v) for k, v in fields.items()})
        line = json.dumps(record, separators=(",", ":"))
        with _lock:
            sink = _get_sink(directory)
            if sink is not None:
                sink.write(line + "\n")
                sink.flush()
    except Exception:
        pass


def close_sink() -> None:
    """Flush and close the JSONL sink (tests, shutdown)."""
    global _sink, _sink_dir
    with _lock:
        if _sink is not None:
            try:
                _sink.close()
            except Exception:
                pass
        _sink, _sink_dir = None, None
