"""The host's accelerator lease (counterpart of
analytics_zoo_tpu/common/device_lease.py): AutoML trial placement on a
card that cannot be shared in fractions.

* One process holds the CUDA card.  Everything that wants it runs in
  that process and takes turns through this lease: search trials,
  concurrent serving loads, benchmark stages.
* Trials that fit on the CPU go to spawned worker processes that see no
  CUDA device (SearchEngine backend="process", which exports
  CUDA_VISIBLE_DEVICES="" around the spawn): they never touch the card,
  so they run side by side on the host's cores.
* Card-bound trials use SearchEngine backend="device": every trial runs
  in the card-holding process, one at a time through this lease, so
  they share the process's CUDA context, its caching allocator and the
  kernels already built.

The lease is a plain mutex, not a semaphore: two programs on one card
contend for the same SMs and HBM, so admission is all or nothing.  Wake
order among waiters is the OS's, not strictly FIFO: callers may depend
on exclusivity, not on arrival order.  The holder's name and the wait
and hold statistics are exposed for tests and observability, and each
wait and hold is recorded in the registry's `device_lease_wait_seconds`
and `device_lease_hold_seconds` histograms.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, List, Optional

from analytics_zoo_tpu_torch.observability import get_registry, now

_lock = threading.Lock()          # the lease itself (exclusive, not FIFO)
_state_lock = threading.Lock()    # guards the bookkeeping below
_current_holder: Optional[str] = None
_stats: Dict[str, float] = {"acquisitions": 0, "total_wait_s": 0.0,
                            "total_hold_s": 0.0}
_history: List[str] = []          # bounded holder log, newest last


def current_holder() -> Optional[str]:
    return _current_holder


def stats() -> Dict[str, float]:
    with _state_lock:
        return dict(_stats)


def history(n: int = 32) -> List[str]:
    with _state_lock:
        return _history[-n:]


@contextmanager
def device_lease(name: str = "anonymous", timeout: Optional[float] = None):
    """Hold the host's accelerator exclusively.

    >>> with device_lease("trial-3"):
    ...     pass  # launch work on the card here
    """
    global _current_holder
    t0 = now()
    ok = _lock.acquire(timeout=timeout if timeout is not None else -1)
    if not ok:
        raise TimeoutError(
            f"device lease not acquired within {timeout}s "
            f"(held by {_current_holder!r})")
    waited = now() - t0
    get_registry().histogram(
        "device_lease_wait_seconds",
        help="time spent waiting for the host accelerator lease",
    ).record(waited)
    with _state_lock:
        _current_holder = name
        _stats["acquisitions"] += 1
        _stats["total_wait_s"] += waited
        _history.append(name)
        del _history[:-256]
    t1 = now()
    try:
        yield
    finally:
        held = now() - t1
        get_registry().histogram(
            "device_lease_hold_seconds",
            help="time the host accelerator lease was held",
        ).record(held)
        with _state_lock:
            _current_holder = None
            _stats["total_hold_s"] += held
        _lock.release()
