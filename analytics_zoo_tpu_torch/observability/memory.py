"""Memory telemetry (a copy of analytics_zoo_tpu/observability/
memory.py): host RSS, the card's allocated and reserved bytes, pool
occupancy.

The OOM class of failure (host heap creep, device memory exhausted by a
leaked tensor, a KV pool running hot) is invisible to latency metrics
until the kill.  This module keeps a bounded ring of memory samples on
the wall-time axis, high-watermark gauges and a snapshot for
flight-recorder bundles.

Each sample records:

* ``host_rss_bytes`` — the process resident set (``/proc/self/statm``
  where available, else the ``ru_maxrss`` peak),
* ``device_allocated_bytes`` / ``device_reserved_bytes`` —
  `torch.cuda.memory_allocated` / `memory_reserved` of the current
  device, read only when this process has already initialized CUDA
  (sampling never brings a CUDA context up); 0 otherwise.  They take
  the place of JAX's ``jax_live_buffer_bytes`` (the bytes of
  `jax.live_arrays()`): torch's caching allocator counts the bytes its
  live tensors hold, and what it keeps reserved beside them,
* every registered **provider**'s fields — the generation engine's KV
  block pool registers its occupancy under the name ``kv_pool``,
  flattened into the sample as ``kv_pool_<field>``.

Sampling is opportunistic and time-gated: fenced goodput steps call
`maybe_sample()` (at most one sample per
`OrcaContext.memory_sample_interval_s`), and flight-recorder dumps
force one.  The sampler only reads host-side counters: it launches no
work on the card and waits on none.

Gauges (min/max tracking gives the high-watermarks for free):
``memory_host_rss_bytes``, ``memory_device_allocated_bytes``,
``memory_device_reserved_bytes`` and the ``memory_<provider>_<field>``
family.  `snapshot()` returns the latest sample plus peaks.
"""

from __future__ import annotations

import inspect
import os
import sys
import threading
import time
import weakref
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from analytics_zoo_tpu_torch.observability.registry import get_registry, now

#: sample ring capacity (the timeline memory track's depth)
RING_SIZE = 512

_lock = threading.Lock()
_samples: "deque[Dict[str, Any]]" = deque(maxlen=RING_SIZE)
_providers: Dict[str, Callable[[], Dict[str, float]]] = {}
_peaks: Dict[str, float] = {}
_n_samples = 0
_last_sample_t: Optional[float] = None

_PAGE_SIZE = None

#: the sample's own fields; every other one is a provider's
_PROCESS_FIELDS = ("ts", "host_rss_bytes", "device_allocated_bytes",
                   "device_reserved_bytes")


def register_provider(name: str,
                      fn: Callable[[], Dict[str, float]]) -> None:
    """Register (or replace) a named memory provider; `fn` returns a
    flat dict of numeric fields sampled alongside the process stats.
    A bound method is held weakly: the registry does not keep its owner
    (an engine with its model and KV pool on the card) alive, and the
    provider is dropped once the owner is collected."""
    if inspect.ismethod(fn):
        fn = weakref.WeakMethod(fn)
    with _lock:
        _providers[name] = fn


def unregister_provider(name: str) -> None:
    with _lock:
        _providers.pop(name, None)


def _host_rss_bytes() -> int:
    """Current RSS from /proc (linux); on other platforms fall back to
    the ru_maxrss PEAK (better than nothing for watermarks)."""
    global _PAGE_SIZE
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        if _PAGE_SIZE is None:
            _PAGE_SIZE = os.sysconf("SC_PAGE_SIZE")
        return pages * _PAGE_SIZE
    except Exception:
        try:
            import resource
            peak_kb = resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss
            return int(peak_kb) * 1024
        except Exception:
            return 0


def _device_bytes() -> Tuple[int, int]:
    """(allocated, reserved) bytes of torch's caching allocator on the
    current CUDA device, without initializing CUDA (0, 0 when this
    process has not)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return 0, 0
    try:
        if not torch.cuda.is_initialized():
            return 0, 0
        return (int(torch.cuda.memory_allocated()),
                int(torch.cuda.memory_reserved()))
    except Exception:
        return 0, 0


def _interval_s() -> Optional[float]:
    from analytics_zoo_tpu_torch.common.context import OrcaContext
    return OrcaContext.memory_sample_interval_s


def sample() -> Dict[str, Any]:
    """Take one sample now: read the sources, update gauges/peaks,
    append to the ring.  Never raises."""
    global _n_samples, _last_sample_t
    allocated, reserved = _device_bytes()
    s: Dict[str, Any] = {
        "ts": round(time.time(), 6),
        "host_rss_bytes": _host_rss_bytes(),
        "device_allocated_bytes": allocated,
        "device_reserved_bytes": reserved,
    }
    with _lock:
        providers = list(_providers.items())
    for name, fn in providers:
        if isinstance(fn, weakref.WeakMethod):
            ref, fn = fn, fn()
            if fn is None:            # its owner was collected
                with _lock:
                    if _providers.get(name) is ref:
                        del _providers[name]
                continue
        try:
            for k, v in fn().items():
                s[f"{name}_{k}"] = float(v)
        except Exception:
            pass
    try:
        reg = get_registry()
        reg.counter("memory_samples_total",
                    help="memory-telemetry samples taken").inc()
        reg.gauge("memory_host_rss_bytes",
                  help="process resident set size at the last sample "
                       "(gauge max = high watermark)"
                  ).set(s["host_rss_bytes"])
        reg.gauge("memory_device_allocated_bytes",
                  help="bytes of live torch tensors on the card at the "
                       "last sample (gauge max = high watermark)"
                  ).set(s["device_allocated_bytes"])
        reg.gauge("memory_device_reserved_bytes",
                  help="bytes torch's caching allocator holds on the card "
                       "at the last sample (gauge max = high watermark)"
                  ).set(s["device_reserved_bytes"])
        for k, v in s.items():
            if k in _PROCESS_FIELDS:
                continue
            # provider fields ride the memory_<provider>_<field> family
            reg.gauge(f"memory_{k}",
                      help="memory provider field").set(v)
    except Exception:
        pass
    with _lock:
        for k, v in s.items():
            if k == "ts":
                continue
            if v > _peaks.get(k, float("-inf")):
                _peaks[k] = v
        _samples.append(s)
        _n_samples += 1
        _last_sample_t = now()
    return s


def maybe_sample(force: bool = False) -> Optional[Dict[str, Any]]:
    """Time-gated sampling for opportunistic call sites (fenced goodput
    steps).  At most one sample per
    `OrcaContext.memory_sample_interval_s`; None interval disables
    opportunistic sampling entirely.  `force=True` bypasses the gate
    (flight-recorder dumps)."""
    try:
        if not force:
            interval = _interval_s()
            if interval is None:
                return None
            with _lock:
                last = _last_sample_t
            if last is not None and now() - last < interval:
                return None
        return sample()
    except Exception:
        return None


def samples(n: Optional[int] = None) -> List[Dict[str, Any]]:
    """Ring contents, oldest first; at most `n` newest."""
    with _lock:
        items = list(_samples)
    if n is not None:
        items = items[-int(n):]
    return items


def snapshot() -> Dict[str, Any]:
    """Latest sample + high watermarks (the flight-bundle payload)."""
    with _lock:
        latest = dict(_samples[-1]) if _samples else None
        peaks = dict(_peaks)
        n = _n_samples
    return {"latest": latest, "peaks": peaks, "n_samples": n}


def reset() -> None:
    """Drop samples, peaks and providers (tests)."""
    global _n_samples, _last_sample_t
    with _lock:
        _samples.clear()
        _peaks.clear()
        _providers.clear()
        _n_samples = 0
        _last_sample_t = None
