"""Watchdog (a copy of analytics_zoo_tpu/observability/watchdog.py):
stall detection and nonfinite localization.

Two failure modes metrics alone cannot catch in time:

* **stalls** — a wedged queue or a hung launch: the process is alive,
  every gauge is frozen, and nothing fires.  `Watchdog` is a daemon
  thread fed heartbeats (`beat()`) by the hot loops (one per training
  step or scheduling round); when no progress lands for `deadline_s`
  it increments ``watchdog_stall_total``, writes a flight-recorder
  bundle (the stack of every thread shows WHERE it is stuck) and keeps
  watching: one dump per stall episode, re-armed by the next beat.

* **nonfinite values** — the train step always computes its
  ``_nan_steps`` stat on the device.  The opt-in sentinel
  (`OrcaContext.nonfinite_watchdog`) makes the host read that stat per
  step and, on a trip, run `localize_nonfinite`, a host-side
  per-tensor pass that names the first nonfinite tensor, and dump a
  bundle.

`nonfinite_leaves` / `localize_nonfinite` walk nested dicts, lists and
tuples of tensors or arrays, such as `dict(module.named_parameters())`,
predictions and gradients, with the paths and order of JAX's
`jax.tree_util` (dict keys sorted, ``['name']`` / ``[0]``).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.observability import flight_recorder
from analytics_zoo_tpu_torch.observability.profiling import (
    _dtype_name,
    flatten_with_paths,
)
from analytics_zoo_tpu_torch.observability.registry import get_registry, now


class Watchdog:
    """Stall detector for one hot loop.

    name: label for metrics/bundles (e.g. "estimator_fit").
    deadline_s: max seconds between beats before a stall fires.
    on_stall: optional callback(run_seconds_since_last_beat).
    dump: write a flight-recorder bundle on stall (default True).

    Use as a context manager (arms on enter, disarms on exit) or call
    `arm()`/`disarm()` explicitly; `beat()` from the observed loop.
    The watcher thread is started lazily on first arm and polls at
    deadline/4 (min 50 ms) — idle cost is one sleeping daemon thread.
    """

    def __init__(self, name: str, deadline_s: float,
                 on_stall: Optional[Callable[[float], None]] = None,
                 dump: bool = True):
        if deadline_s <= 0:
            raise ValueError("deadline_s must be > 0")
        self.name = name
        self.deadline_s = float(deadline_s)
        self.on_stall = on_stall
        self._dump = dump
        self._lock = threading.Lock()
        self._last_beat = now()
        self._armed = False
        self._fired = False      # one dump per stall episode
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._c_stalls = get_registry().counter(
            "watchdog_stall_total",
            help="stall episodes detected by watchdogs")
        self.stalls = 0

    # ------------------------------------------------------------------

    def beat(self) -> None:
        """Progress heartbeat: call once per step/iteration."""
        with self._lock:
            self._last_beat = now()
            self._fired = False

    def arm(self) -> "Watchdog":
        with self._lock:
            self._last_beat = now()
            self._fired = False
            self._armed = True
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._watch, name=f"watchdog-{self.name}",
                daemon=True)
            self._thread.start()
        return self

    def disarm(self) -> None:
        with self._lock:
            self._armed = False

    def stop(self) -> None:
        self.disarm()
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        self._stop.clear()

    def __enter__(self) -> "Watchdog":
        return self.arm()

    def __exit__(self, *exc) -> bool:
        self.disarm()
        return False

    # ------------------------------------------------------------------

    def _watch(self) -> None:
        poll = max(0.05, self.deadline_s / 4.0)
        while not self._stop.wait(poll):
            with self._lock:
                if not self._armed or self._fired:
                    continue
                stalled = now() - self._last_beat
                if stalled < self.deadline_s:
                    continue
                self._fired = True
            self._trip(stalled)

    def _trip(self, stalled: float) -> None:
        self.stalls += 1
        self._c_stalls.inc()
        flight_recorder.record("watchdog_stall", watchdog=self.name,
                               stalled_s=round(stalled, 3),
                               deadline_s=self.deadline_s)
        if self._dump:
            flight_recorder.dump(
                "watchdog_stall",
                extra={"watchdog": self.name,
                       "stalled_s": round(stalled, 3),
                       "deadline_s": self.deadline_s})
        if self.on_stall is not None:
            try:
                self.on_stall(stalled)
            except Exception:
                pass


def maybe_watchdog(name: str,
                   deadline_s: Optional[float] = None
                   ) -> Optional[Watchdog]:
    """Build a Watchdog when a deadline is configured: explicit
    `deadline_s` wins, else `OrcaContext.watchdog_deadline_s`, else
    None (watchdog off — the default)."""
    if deadline_s is None:
        from analytics_zoo_tpu_torch.common.context import OrcaContext
        deadline_s = OrcaContext.watchdog_deadline_s
    if deadline_s is None:
        return None
    return Watchdog(name, deadline_s)


# ----------------------------------------------------------------------
# nonfinite localization
# ----------------------------------------------------------------------

def _nonfinite_counts(leaf: Any) -> Optional[Tuple[List[int], str, int,
                                                    int]]:
    """(shape, dtype, nonfinite, nan) of one floating leaf that holds a
    nonfinite value; None for a finite or non-floating one.  A tensor is
    counted where it lies and only the counts are read back."""
    if isinstance(leaf, torch.Tensor):
        if not (leaf.is_floating_point() or leaf.is_complex()):
            return None
        t = leaf.detach()
        finite = torch.isfinite(t)
        if bool(finite.all()):
            return None
        n_bad = int(t.numel() - int(finite.sum()))
        return (list(t.shape), _dtype_name(t.dtype), n_bad,
                int(torch.isnan(t).sum()))
    try:
        a = np.asarray(leaf)
    except Exception:
        return None
    if a.dtype.kind not in "fc":
        return None
    finite = np.isfinite(a)
    if finite.all():
        return None
    return (list(a.shape), str(a.dtype), int(a.size - finite.sum()),
            int(np.isnan(a).sum()))


def nonfinite_leaves(tree: Any, max_leaves: int = 8,
                     prefix: str = "") -> List[Dict[str, Any]]:
    """Host-side per-tensor pass over a nested structure: the path,
    shape, dtype and nonfinite counts (nan/inf) of up to `max_leaves`
    offending leaves, in tree order, so [0] is "the first nonfinite
    leaf".  This runs on the cold post-mortem path, not the hot loop."""
    out: List[Dict[str, Any]] = []
    for path, leaf in flatten_with_paths(tree):
        if len(out) >= max_leaves:
            break
        found = _nonfinite_counts(leaf)
        if found is None:
            continue
        shape, dtype, n_bad, n_nan = found
        out.append({
            "path": prefix + path,
            "shape": shape,
            "dtype": dtype,
            "nonfinite": n_bad,
            "nan": n_nan,
            "inf": n_bad - n_nan,
        })
    return out


def localize_nonfinite(trees: Dict[str, Any],
                       max_leaves: int = 8) -> List[Dict[str, Any]]:
    """Scan several labeled trees ({"params": ..., "grads": ...}) in
    the given order and return the offending leaves across all of them
    (first entry = first nonfinite leaf of the first dirty tree)."""
    found: List[Dict[str, Any]] = []
    for label, tree in trees.items():
        if len(found) >= max_leaves:
            break
        found.extend(nonfinite_leaves(
            tree, max_leaves=max_leaves - len(found),
            prefix=label + ":"))
    return found
