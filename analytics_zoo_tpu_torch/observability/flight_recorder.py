"""Flight recorder (a copy of analytics_zoo_tpu/observability/
flight_recorder.py): always-on black-box diagnostics.

A bounded in-memory ring of recent happenings (step records, scheduler
lane decisions, structured events) that costs one deque append in the
steady state and, when something dies, is written out as a post-mortem
bundle instead of vanishing with the process.

``record(kind, **fields)`` appends to the ring (never raises, never
blocks on I/O).  ``dump(reason)`` writes a redacted JSON bundle to
`OrcaContext.observability_dir` with JAX's keys (`BUNDLE_KEYS`):

* the ring (newest last) and the most recent completed spans,
* a metrics-registry snapshot, the goodput tables, the memory snapshot,
  the dispatch ledger and its compile events,
* ``torch``: torch's and CUDA's versions and the card names, read
  without creating a CUDA context when none exists (JAX's ``jax``
  section holds its backend and devices),
* the Python stacks of every live thread,
* the trigger reason plus caller-supplied context.

* the metrics history's recent samples and the firing alerts
  (``history_tail``, ``alerts_active``; empty while the history plane
  is disarmed), the worst tail exemplars (``exemplars``), and
  ``timeline_path``: a Perfetto sibling ``*.trace.json`` of the merged
  timeline, written beside the bundle (None when that write fails).

``install()`` arms the process: `sys.excepthook` is wrapped so an
unhandled exception dumps before the traceback prints; SIGTERM and
SIGABRT raised at the Python level dump when handlers can be installed
(main thread only); and, when a directory is configured,
`faulthandler` writes to a ``*.stacks`` file there, so a hard crash in
native code still leaves the thread stacks behind.

Everything here is observability: failures to record or dump are
swallowed, never raised into the path being observed.
"""

from __future__ import annotations

import faulthandler
import json
import os
import re
import signal
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, List, Optional

from analytics_zoo_tpu_torch.observability.registry import get_registry

#: ring capacity; sized so a few hundred steps of spans + events +
#: scheduler decisions survive, small enough to dump in one JSON file
RING_SIZE = 512

#: the keys of every bundle (`dump` adds ``exception`` and ``extra``
#: when given): JAX's, with ``torch`` where JAX writes ``jax``
BUNDLE_KEYS = ("reason", "ts", "pid", "argv", "torch", "ring", "spans",
               "metrics", "goodput", "memory", "history_tail",
               "alerts_active", "dispatch", "compile_events", "exemplars",
               "thread_stacks", "timeline_path")

_lock = threading.Lock()
_ring: "deque[Dict[str, Any]]" = deque(maxlen=RING_SIZE)
_installed = False
_prev_excepthook = None
_fault_file = None

#: field keys / string shapes that never belong in a bundle on disk
_SECRET_KEY_RE = re.compile(
    r"(key|token|secret|password|credential|authorization)", re.I)
_SECRET_VAL_RE = re.compile(
    r"(sk-[A-Za-z0-9_\-]{8,}|Bearer\s+\S+|eyJ[A-Za-z0-9_\-]{10,}\.)")


def _configured_dir() -> Optional[str]:
    from analytics_zoo_tpu_torch.common.context import OrcaContext
    return OrcaContext.observability_dir


def record(kind: str, **fields) -> None:
    """Append one entry to the flight ring.  Never raises."""
    try:
        entry = {"ts": round(time.time(), 6), "kind": kind}
        entry.update(fields)
        with _lock:
            _ring.append(entry)
    except Exception:
        pass


def ring_contents() -> List[Dict[str, Any]]:
    """Copy of the ring, oldest first."""
    with _lock:
        return list(_ring)


def clear_ring() -> None:
    """Drop the ring (tests)."""
    with _lock:
        _ring.clear()


def _redact(obj: Any) -> Any:
    """Scrub secret-shaped keys/values before anything hits disk."""
    if isinstance(obj, dict):
        return {k: ("<redacted>" if isinstance(k, str)
                    and _SECRET_KEY_RE.search(k) else _redact(v))
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_redact(v) for v in obj]
    if isinstance(obj, str) and _SECRET_VAL_RE.search(obj):
        return _SECRET_VAL_RE.sub("<redacted>", obj)
    return obj


def _thread_stacks() -> Dict[str, List[str]]:
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for ident, frame in sys._current_frames().items():
        label = f"{names.get(ident, 'unknown')}-{ident}"
        out[label] = traceback.format_stack(frame)
    return out


def _torch_info() -> Dict[str, Any]:
    """torch's and CUDA's versions and the card names, WITHOUT
    initializing anything: the devices are read only when this process
    already holds a CUDA context."""
    torch = sys.modules.get("torch")
    if torch is None:
        return {"imported": False}
    info: Dict[str, Any] = {"imported": True,
                            "version": getattr(torch, "__version__", "?"),
                            "cuda": getattr(torch.version, "cuda", None)}
    try:
        if torch.cuda.is_initialized():
            info["backend"] = "cuda"
            info["devices"] = [torch.cuda.get_device_name(i)
                               for i in range(torch.cuda.device_count())]
        else:
            info["backend"] = "cpu"
            info["devices"] = ["cpu"]
    except Exception:
        pass
    return info


def dump(reason: str, extra: Optional[Dict[str, Any]] = None,
         exc: Optional[BaseException] = None) -> Optional[str]:
    """Write the post-mortem bundle; returns its path, or None when no
    `OrcaContext.observability_dir` is configured or the write failed.
    Safe to call from any thread, including signal/except hooks."""
    try:
        get_registry().counter(
            "flight_recorder_dumps_total",
            help="flight-recorder bundles written").inc()
        record("flight_dump", reason=reason)
        directory = _configured_dir()
        if directory is None:
            return None
        os.makedirs(directory, exist_ok=True)
        from analytics_zoo_tpu_torch.observability.events import _jsonable
        from analytics_zoo_tpu_torch.observability.tracing import recent_spans
        bundle: Dict[str, Any] = {
            "reason": reason,
            "ts": round(time.time(), 6),
            "pid": os.getpid(),
            "argv": list(sys.argv),
            "torch": _torch_info(),
            "ring": ring_contents(),
            "spans": recent_spans(100),
            "metrics": get_registry().snapshot(),
            "goodput": _goodput_tables_safe(),
            "memory": _memory_snapshot_safe(),
            "history_tail": _history_tail_safe(),
            "alerts_active": _alerts_active_safe(),
            "dispatch": _dispatch_safe(),
            "compile_events": _compile_events_safe(),
            "exemplars": _exemplars_safe(),
            "thread_stacks": _thread_stacks(),
        }
        if exc is not None:
            bundle["exception"] = {
                "type": type(exc).__name__,
                "message": str(exc),
                "traceback": traceback.format_exception(
                    type(exc), exc, exc.__traceback__),
            }
        if extra:
            bundle["extra"] = extra
        stem = os.path.join(
            directory,
            f"flight_{int(time.time() * 1e3)}_{os.getpid()}")
        # the Perfetto sibling: the merged timeline around the moment
        # of death, written FIRST so the bundle names only a trace that
        # exists
        trace_path = None
        try:
            from analytics_zoo_tpu_torch.observability import (
                memory,
                timeline,
            )
            memory.maybe_sample(force=True)
            trace_path = timeline.write_timeline(stem + ".trace.json")
        except Exception:
            trace_path = None
        bundle["timeline_path"] = trace_path
        bundle = _redact(_jsonable(bundle))
        path = stem + ".json"
        with open(path, "w", encoding="utf-8") as f:
            json.dump(bundle, f, indent=1)
        return path
    except Exception:
        return None


def _history_tail_safe(n: int = 64) -> List[Dict[str, Any]]:
    """The recorder's recent samples, so a post-mortem shows the
    minutes before the crash (empty while the history plane is
    disarmed)."""
    try:
        from analytics_zoo_tpu_torch.observability import history
        rec = history.get_recorder()
        return rec.tail(n) if rec is not None else []
    except Exception:
        return []


def _alerts_active_safe() -> Dict[str, Any]:
    try:
        from analytics_zoo_tpu_torch.observability import history
        rec = history.get_recorder()
        if rec is None or rec.alerts is None:
            return {}
        return rec.alerts.evaluate(rec.tail()).get("active", {})
    except Exception:
        return {}


def _exemplars_safe(n: int = 8) -> List[Dict[str, Any]]:
    """The worst `n` tail exemplars (exemplars.py): a post-mortem
    opens with the requests that were already hurting."""
    try:
        from analytics_zoo_tpu_torch.observability.exemplars import (
            get_exemplar_store,
        )
        return get_exemplar_store().snapshot()[:n]
    except Exception:
        return []


def _goodput_tables_safe() -> Dict[str, Any]:
    try:
        from analytics_zoo_tpu_torch.observability import goodput
        return goodput.goodput_tables()
    except Exception:
        return {}


def _memory_snapshot_safe() -> Dict[str, Any]:
    try:
        from analytics_zoo_tpu_torch.observability import memory
        return memory.snapshot()
    except Exception:
        return {}


def _dispatch_safe() -> Dict[str, Any]:
    """Per-family dispatch-ledger rows + MFU block (empty when no
    ledgered program has dispatched)."""
    try:
        from analytics_zoo_tpu_torch.observability import profiling
        snap = profiling.ledger_snapshot()
        snap.pop("compile_events", None)   # own bundle section below
        return snap if snap.get("families") else {}
    except Exception:
        return {}


def _compile_events_safe(n: int = 32) -> List[Dict[str, Any]]:
    """The compile-forensics tail: the last `n` compile events with
    their signature diffs — a recompile post-mortem names the guilty
    leaf straight from the bundle."""
    try:
        from analytics_zoo_tpu_torch.observability import profiling
        return profiling.compile_events(n)
    except Exception:
        return []


def find_bundles(directory: Optional[str] = None) -> List[str]:
    """Bundle paths under `directory` (default: the configured
    observability dir), oldest first."""
    directory = directory or _configured_dir()
    if not directory or not os.path.isdir(directory):
        return []
    return sorted(
        os.path.join(directory, fn) for fn in os.listdir(directory)
        if fn.startswith("flight_") and fn.endswith(".json")
        and not fn.endswith(".trace.json"))   # timeline siblings


# ----------------------------------------------------------------------
# arming
# ----------------------------------------------------------------------

def _excepthook(exc_type, exc, tb):
    try:
        dump("unhandled_exception", exc=exc)
    finally:
        (_prev_excepthook or sys.__excepthook__)(exc_type, exc, tb)


def _signal_handler(signum, frame):
    dump(f"signal_{signal.Signals(signum).name}")
    # restore + re-raise so the process still dies with the right code
    signal.signal(signum, signal.SIG_DFL)
    os.kill(os.getpid(), signum)


def install(signals: bool = True) -> None:
    """Arm the flight recorder for this process (idempotent).

    * wraps `sys.excepthook` (dump-then-chain),
    * with `signals` and when running on the main thread, installs
      SIGTERM/SIGABRT handlers (an ``abort()`` in native code kills the
      process before Python bytecode runs, so for that class only the
      faulthandler file below helps),
    * when an observability dir is configured, points `faulthandler`
      at ``<dir>/flight_<pid>.stacks`` so hard crashes (SIGSEGV/
      SIGABRT from native code) still leave every thread's stack on
      disk.
    """
    global _installed, _prev_excepthook, _fault_file
    if _installed:
        return
    _installed = True
    _prev_excepthook = sys.excepthook
    sys.excepthook = _excepthook
    if signals and threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGABRT):
            try:
                signal.signal(sig, _signal_handler)
            except (ValueError, OSError):
                pass
    directory = _configured_dir()
    if directory is not None:
        try:
            os.makedirs(directory, exist_ok=True)
            _fault_file = open(
                os.path.join(directory,
                             f"flight_{os.getpid()}.stacks"), "w")
            faulthandler.enable(file=_fault_file)
        except Exception:
            _fault_file = None


def uninstall() -> None:
    """Disarm (tests): restore the excepthook and faulthandler."""
    global _installed, _prev_excepthook, _fault_file
    if not _installed:
        return
    _installed = False
    if _prev_excepthook is not None:
        sys.excepthook = _prev_excepthook
        _prev_excepthook = None
    if _fault_file is not None:
        try:
            faulthandler.disable()
            _fault_file.close()
        except Exception:
            pass
        _fault_file = None
